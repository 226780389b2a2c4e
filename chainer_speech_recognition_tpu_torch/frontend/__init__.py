"""Audio front-end implementations + selection.

``select_frontend`` maps ``features.frontend_impl`` to a batch-features
function, as the reference's ``frontend.select_frontend`` does:
"auto" and "pallas" take the fused kernel (``cuda_frontend``), whose
wrapper launches it for CUDA tensors and runs its plain rfft version for
CPU tensors; "jnp" takes the plain version on either device.
"""


def select_frontend(features_cfg):
    from .cuda_frontend import batch_features_cuda
    from .torch_frontend import batch_features

    impl = features_cfg.frontend_impl
    table = {"auto": batch_features_cuda, "pallas": batch_features_cuda,
             "jnp": batch_features}
    if impl not in table:
        raise ValueError(f"features.frontend_impl={impl!r}: expected one of "
                         f"{tuple(table)}")
    return table[impl]
