"""Frozen DSP + label conventions: the port's copy of the reference's
``constants.py`` (the parity contract), so the port imports nothing of the
JAX package. ``tests/test_torch_copies.py`` holds the copy to the original.
"""

# ----------------------------------------------------------------------------
# Audio front-end (librosa-default-equivalent choices, documented per knob)
# ----------------------------------------------------------------------------

SAMPLE_RATE = 16_000          # Hz; reference corpus (CSJ) is 16 kHz PCM
N_FFT = 512                   # rfft size; 32 ms @ 16 kHz, power of two
WIN_LENGTH = 400              # 25 ms analysis window
HOP_LENGTH = 160              # 10 ms frame shift
WINDOW = "hann_periodic"      # scipy.signal.get_window('hann', fftbins=True)
CENTER = True                 # librosa stft default: reflect-pad N_FFT//2
PAD_MODE = "reflect"
SPECTRUM = "power"            # |STFT|^2 (librosa melspectrogram power=2.0)

N_MELS = 40                   # mel bins (classic fbank ASR setup)
MEL_FMIN = 0.0
MEL_FMAX = SAMPLE_RATE / 2.0
MEL_SCALE = "slaney"          # librosa default htk=False
MEL_NORM = "slaney"           # librosa default norm='slaney' (area-normalized)

LOG_EPS = 1e-10               # log(max(mel, LOG_EPS)); natural log
DELTA_WINDOW = 2              # regression-window half-width for Δ / ΔΔ
DELTA_EDGE = "replicate"      # edge frames replicated before regression
N_FEATURE_CHANNELS = 3        # [static, Δ, ΔΔ] stacked as channels
CMVN_VAR_EPS = 1e-8           # (x - mean) / sqrt(var + eps), per utterance

# Feature tensor layout: float32 [T_frames, N_MELS, 3], time-major.
# T_frames for a length-N signal with CENTER=True: 1 + N // HOP_LENGTH.


def num_frames(num_samples: int) -> int:
    """Frame count of the centered STFT for a 1-D signal of given length."""
    return 1 + num_samples // HOP_LENGTH


# ----------------------------------------------------------------------------
# Label / CTC conventions
# ----------------------------------------------------------------------------

BLANK_ID = 0                  # Chainer F.ctc default blank_symbol=0
PAD_LABEL_ID = -1             # padding value in label tensors (never a vocab id)
# Vocabulary ids are therefore 1..V for real symbols; logits have V+1 classes
# with class 0 = blank. The vocab file format (vocab.py) enforces this.

# ----------------------------------------------------------------------------
# Numerics
# ----------------------------------------------------------------------------

FEATURE_DTYPE = "float32"     # front-end output + CTC math stay fp32
COMPUTE_DTYPE = "bfloat16"    # model matmul dtype on TPU (params stay fp32)
