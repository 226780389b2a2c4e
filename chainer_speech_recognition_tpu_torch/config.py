"""Typed configuration tree: the port's copy of the reference's
``config.py``, whole, so a ``config.json`` frozen into a checkpoint by
either package reads back identically in the other
(``tests/test_torch_copies.py`` compares ``to_json`` for every preset).
Every field is kept so the layout matches; the port runs every preset,
model family and data mode the fields select (attention, the LSTM and the
device cache among them).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any

from . import constants as C


@dataclass(frozen=True)
class FeatureConfig:
    """DSP parameters are the FROZEN parity contract (constants.py): they
    are recorded here so every checkpoint's config.json documents the
    front-end it was trained with, but they are not tunable — all three
    front-end implementations (golden/jnp/Pallas) are specialized to the
    constants, so any override fails loudly at construction instead of
    silently training against a 40-mel front-end (round-1 Weak #3)."""

    sample_rate: int = C.SAMPLE_RATE
    n_fft: int = C.N_FFT
    win_length: int = C.WIN_LENGTH
    hop_length: int = C.HOP_LENGTH
    n_mels: int = C.N_MELS
    fmin: float = C.MEL_FMIN
    fmax: float = C.MEL_FMAX
    log_eps: float = C.LOG_EPS
    delta_window: int = C.DELTA_WINDOW
    cmvn: bool = True               # per-utterance CMVN (config 3, BASELINE.json:9)
    cmvn_mode: str = "utterance"    # "utterance" (reference convention) |
                                    # "causal" (running stats up to each
                                    # frame — the streamable mode required
                                    # by decode/streaming.py; train with it
                                    # to deploy the model online)
    use_cache: bool = False         # feed precomputed .npy features instead of
                                    # running the on-device front-end (§2.1)
    frontend_impl: str = "auto"     # "auto" | "jnp" | "pallas": auto = fused
                                    # Pallas kernel on TPU (1.6x), jnp rfft
                                    # elsewhere

    _FROZEN = {
        "sample_rate": C.SAMPLE_RATE, "n_fft": C.N_FFT,
        "win_length": C.WIN_LENGTH, "hop_length": C.HOP_LENGTH,
        "n_mels": C.N_MELS, "fmin": C.MEL_FMIN, "fmax": C.MEL_FMAX,
        "log_eps": C.LOG_EPS, "delta_window": C.DELTA_WINDOW,
    }

    def __post_init__(self):
        for name, want in self._FROZEN.items():
            got = getattr(self, name)
            if got != want:
                raise ValueError(
                    f"features.{name}={got!r} differs from the frozen parity "
                    f"constant {want!r} (constants.py) — the DSP parameters "
                    "are not tunable; change constants.py and regenerate the "
                    "golden fixtures if you really mean to move the spec")
        if self.cmvn_mode not in ("utterance", "causal"):
            raise ValueError(
                f"features.cmvn_mode={self.cmvn_mode!r}: expected "
                "'utterance' or 'causal'")

    @property
    def cmvn_arg(self):
        """The ``apply_cmvn`` argument for the front-end implementations:
        False | "utterance" | "causal". Every feature call site routes
        through this so the mode cannot be half-applied."""
        return self.cmvn_mode if self.cmvn else False


@dataclass(frozen=True)
class SpecAugmentConfig:
    enabled: bool = False
    num_time_masks: int = 2
    time_mask_max: int = 40         # frames
    num_freq_masks: int = 2
    freq_mask_max: int = 8          # mel bins


@dataclass(frozen=True)
class ModelConfig:
    """Acoustic model: strided-conv subsampling stack + BiRNN stack + proj."""

    preset: str = "bigru"           # registry key (models/presets.py)
    conv_channels: tuple[int, ...] = (32, 32)
    conv_kernel: tuple[int, int] = (3, 3)
    conv_stride_time: tuple[int, ...] = (2, 2)   # per conv layer
    conv_stride_freq: tuple[int, ...] = (2, 2)
    rnn_type: str = "gru"           # "gru" | "lstm" | "none"
    rnn_layers: int = 3
    rnn_hidden: int = 256
    rnn_bidirectional: bool = True  # False = forward-only stack: the
                                    # zero-lookahead ONLINE configuration —
                                    # streaming equals offline EXACTLY at
                                    # any chunk size (decode/streaming.py)
    glu_blocks: int = 0             # GLU-gated residual conv blocks after
    glu_channels: int = 256         # subsampling (musyoku-style conv CTC)
    attn_blocks: int = 0            # Conformer-style self-attention blocks
    attn_dim: int = 256             # after subsampling (models/attention.py
    attn_heads: int = 4             # — the attention model family; MXU-
    attn_ff_mult: int = 4           # dominated, no sequential-in-time
    attn_conv_kernel: int = 15      # recurrence). 0 = no attention stack.
    attn_chunk: int = 0             # >0: chunk-causal attention (STREAMING
    attn_left_chunks: int = 4       # attention family) — queries attend to
                                    # their own chunk (intra-chunk lookahead)
                                    # + attn_left_chunks cached left chunks,
                                    # and the block conv is causal; trains
                                    # offline with the identical mask, so
                                    # streaming == offline exactly. In
                                    # SUBSAMPLED frames. 0 = global
                                    # attention (offline-only).
    attn_impl: str = "auto"         # "auto" | "einsum" | "flash": auto =
                                    # Pallas flash attention on TPU for
                                    # offline calls (ops/attention_pallas.py)
    attn_residual_dtype: str = "float32"
                                    # conformer residual-stream storage:
                                    # "bfloat16" halves the stream's HBM
                                    # traffic (LN statistics stay fp32 —
                                    # models/attention.py); quality +
                                    # MFU measured in BASELINE.md (r5)
    rnn_impl: str = "auto"          # "auto" | "scan" | "pallas" (models/rnn.py)
    proj_dim: int = 0               # 0 = straight to vocab
    vocab_size: int = 64            # symbols INCLUDING blank (class 0)
    compute_dtype: str = C.COMPUTE_DTYPE
    remat_rnn: bool = False         # jax.checkpoint over each RNN layer scan

    # enum-ish fields fail loudly on typos (FeatureConfig precedent —
    # ADVICE r3: a misspelled impl would silently take the auto branch)
    _ENUMS = {"attn_impl": ("auto", "einsum", "flash"),
              "attn_residual_dtype": ("float32", "bfloat16"),
              "rnn_impl": ("auto", "scan", "pallas"),
              "rnn_type": ("gru", "lstm", "none")}

    def __post_init__(self):
        for field, allowed in self._ENUMS.items():
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(
                    f"model.{field}={v!r}: expected one of {allowed}")


@dataclass(frozen=True)
class BucketConfig:
    """Bucketed-by-length batching (BASELINE.json:5,8): static shapes per bucket."""

    boundaries: tuple[int, ...] = (256, 512, 768, 1024, 1536, 2048)  # frames
    batch_sizes: tuple[int, ...] = (64, 48, 32, 24, 16, 8)   # per bucket
    max_label_len: int = 128


@dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "adam"
    learning_rate: float = 1e-3
    warmup_steps: int = 500
    decay_steps: int = 100_000
    end_lr_scale: float = 0.01
    clip_norm: float = 5.0
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999


@dataclass(frozen=True)
class ParallelConfig:
    """DP mesh over TPU chips, gradient all-reduce over ICI (BASELINE.json:11).

    ``dcn_slices > 1`` generalizes the 1-D ``(data,)`` mesh to a 2-D
    ``(dcn, data)`` mesh for multi-slice pods: batch rows shard over BOTH
    axes (``batch_axes``) and every collective reduces over both, so XLA
    routes the intra-slice partial reduction over ICI and only the
    slice-level partials over DCN (ARCHITECTURE.md §2.7). On single-slice
    hardware (and the CPU test mesh) the 2-D mesh is semantically
    identical to the 1-D one — equality-tested in tests/test_dcn.py."""

    data_axis: str = "data"
    num_devices: int = 0            # 0 = use all visible devices
    dcn_slices: int = 1             # >1: 2-D (dcn_slices, n/dcn_slices) mesh
    dcn_axis: str = "dcn"

    @property
    def batch_axes(self) -> str | tuple[str, str]:
        """Mesh axes the utterance (batch) dim shards over — the value to
        pass wherever a sharding/collective axis name is expected
        (``P(axes)``, ``lax.psum``, ``all_gather``, ``axis_index`` all
        accept the tuple form)."""
        if self.dcn_slices > 1:
            return (self.dcn_axis, self.data_axis)
        return self.data_axis


@dataclass(frozen=True)
class TrainConfig:
    ctc_impl: str = "auto"      # "auto" | "pallas" | "jnp"; auto = pallas
                                # kernel on TPU, lax.scan elsewhere
    data_mode: str = "auto"     # "auto" | "stream" | "device_cache":
                                # device_cache keeps the padded corpus in
                                # HBM (sharded over the mesh) and sends only
                                # [B] indices per step; auto picks it when
                                # the corpus fits device_cache_budget_gb
    device_cache_budget_gb: float = 4.0  # PER-CHIP: the cache is row-
                                # sharded, so an n-chip mesh admits n×
                                # this before falling back to rotating
    cache_features: bool = True  # device_cache mode: run the front-end
                                # ONCE at cache build and keep bf16
                                # features in HBM (245 KB/1024-frame utt —
                                # smaller than int16 PCM) instead of
                                # recomputing ~4 ms of front-end every
                                # step; the reference's precomputed
                                # feature cache (SURVEY.md §2.1), HBM-
                                # resident. False = cache raw PCM.
    cache_dtype: str = "bfloat16"   # feature-cache storage dtype; the
                                # first conv matmul is bf16 anyway under
                                # the production compute dtype. NOTE:
                                # evaluate/decode recompute fp32 features,
                                # so bf16-cache training sees a small
                                # train/inference feature-precision gap —
                                # bounded by test_feature_cache_mode_
                                # matches_recompute and covered by the
                                # parity gates, which train THROUGH this
                                # default path (PARITY.md §3)
    steps_per_dispatch: int = 8  # device_cache mode: K steps per host
                                # dispatch (lax.scan inside the jit) —
                                # amortizes per-dispatch host latency;
                                # logging/eval/ckpt land on K boundaries
    loader_workers: int = 4     # Prefetcher threads (stream mode)
    prefetch_depth: int = 8     # batches in flight ahead of the device
    seed: int = 0
    total_steps: int = 10_000
    log_every: int = 50
    eval_every: int = 1000
    eval_beam: int = 0          # >0: periodic dev eval ALSO scores a K-wide
                                # prefix beam (and beam+LM when eval_lm is
                                # set) from the SAME forward pass, so a
                                # config-4 regression shows during training
                                # not just in post-hoc `evaluate --compare`
    eval_lm: str = ""           # ARPA LM path for the beam+LM eval column
    eval_lm_alpha: float = 0.5  # shallow-fusion weight for the eval column
    eval_lm_beta: float = 1.0   # per-char insertion bonus
    checkpoint_every: int = 1000
    keep_checkpoints: int = 3
    checkpoint_dir: str = "checkpoints"


@dataclass(frozen=True)
class Config:
    features: FeatureConfig = field(default_factory=FeatureConfig)
    specaugment: SpecAugmentConfig = field(default_factory=SpecAugmentConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    buckets: BucketConfig = field(default_factory=BucketConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    # ---- JSON round trip -----------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        def build(tp, val):
            if dataclasses.is_dataclass(tp) and isinstance(val, dict):
                fields = {f.name: f for f in dataclasses.fields(tp)}
                kwargs = {}
                for k, v in val.items():
                    if k not in fields:
                        raise KeyError(f"unknown config key {tp.__name__}.{k}")
                    ft = fields[k].type
                    ftype = _resolve(tp, ft)
                    if dataclasses.is_dataclass(ftype):
                        kwargs[k] = build(ftype, v)
                    elif isinstance(v, list):
                        kwargs[k] = tuple(v)
                    else:
                        kwargs[k] = v
                return tp(**kwargs)
            return val

        return build(cls, d)

    def override(self, dotted: dict[str, Any]) -> "Config":
        """Apply {'model.rnn_hidden': 512}-style CLI overrides."""
        d = dataclasses.asdict(self)
        for key, val in dotted.items():
            node = d
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"unknown config key: {key}")
            node[parts[-1]] = val
        return Config.from_dict(d)


def _resolve(owner, tp):
    """Resolve a (possibly string) dataclass field annotation to a type."""
    if isinstance(tp, str):
        ns = dict(globals())
        return ns.get(tp.split("[")[0], str)
    return tp


# ---------------------------------------------------------------------------
# The five contract configs (BASELINE.json:6-12)
# ---------------------------------------------------------------------------

def preset_config(name: str) -> Config:
    base = Config()
    if name == "tiny_conv":        # config 1: small conv+CTC, greedy, CPU-OK
        return base.override({
            "model.preset": "tiny_conv",
            "model.rnn_type": "none",
            "model.conv_channels": [16, 16],
            "model.rnn_layers": 0,
        })
    if name == "glu_conv":         # musyoku-style conv-only CTC (GLU stack)
        return base.override({
            "model.preset": "glu_conv",
            "model.rnn_type": "none",
            "model.rnn_layers": 0,
            "model.glu_blocks": 6,
            "model.glu_channels": 256,
        })
    if name == "conformer":        # attention family: conv subsampling +
        return base.override({     # macaron MHSA/conv blocks (offline;
            "model.preset": "conformer",   # global receptive field)
            "model.rnn_type": "none",
            "model.rnn_layers": 0,
            "model.attn_blocks": 8,
            "model.attn_dim": 256,
            "model.attn_heads": 4,
            "specaugment.enabled": True,
            # Attention+CTC needs a gentler optimizer than the RNN presets:
            # at the base defaults (lr 1e-3, warmup 500, clip 5) the encoder
            # sits on the all-blank CTC plateau indefinitely (measured: 8+
            # epochs, CER 0.98); at lr 3e-4 / warmup 1000 / clip 1 it exits
            # the plateau around epoch 7 and converges (CER 0.04 by epoch 11
            # on the parity corpus, still improving).
            "optim.learning_rate": 3e-4,
            "optim.warmup_steps": 1000,
            "optim.clip_norm": 1.0,
        })
    if name == "conformer_stream":  # ONLINE attention family: chunk-causal
        return base.override({      # MHSA (own chunk + 4 cached left chunks)
            "model.preset": "conformer_stream",  # + causal depthwise conv +
            "model.rnn_type": "none",            # causal CMVN — streams
            "model.rnn_layers": 0,               # EXACTLY (KV-cache carries,
            "model.attn_blocks": 8,              # decode/streaming.py)
            "model.attn_dim": 256,
            "model.attn_heads": 4,
            "model.attn_chunk": 16,        # 16 subsampled frames = 640 ms
                                           # — chosen for SERVING cost
                                           # (half the per-stream dispatch
                                           # rate of chunk 8); the measured
                                           # latency↔quality Pareto
                                           # (PARITY.md §3g-bis) shows
                                           # chunk 8 = better CER at half
                                           # the latency for deployments
                                           # that can afford 2× steps
            "model.attn_left_chunks": 4,   # 2.56 s cached left context
            "features.cmvn_mode": "causal",
            "specaugment.enabled": True,
            # same plateau-exiting recipe as the offline conformer preset
            "optim.learning_rate": 3e-4,
            "optim.warmup_steps": 1000,
            "optim.clip_norm": 1.0,
        })
    if name == "bigru":            # config 2: conv subsampling + 3-layer BiGRU
        return base.override({
            "model.preset": "bigru",
            "model.rnn_type": "gru",
            "model.rnn_layers": 3,
        })
    if name == "uni_gru":          # online config: forward-only GRU stack —
        return base.override({     # zero-lookahead exact streaming
            "model.preset": "uni_gru",
            "model.rnn_type": "gru",
            "model.rnn_layers": 4,  # one extra layer: recover some of the
            "model.rnn_bidirectional": False,   # missing right context
            "features.cmvn_mode": "causal",     # streamable end to end
        })
    if name == "bilstm_deep":      # config 3: deep BiLSTM + CMVN + SpecAugment
        cfg = base.override({
            "model.preset": "bilstm_deep",
            "model.rnn_type": "lstm",
            "model.rnn_layers": 5,
            "model.rnn_hidden": 384,   # multiple of 128: Pallas RNN tiling
            "specaugment.enabled": True,
            "features.cmvn": True,
        })
        return cfg
    raise KeyError(f"unknown preset config: {name}")
