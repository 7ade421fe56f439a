"""The port's CUDA kernels: the row member family, decode attention,
prefill attention (both contiguous and paged), the grouped expert FFN, the
AdamW update and the seven paper-suite bodies, all launched through the
bundle launcher (``core/hfuse.py``, source ``csrc/bundle.cu``)."""


def registry():
    """The port's hand-written kernels, in report order: the bundle
    launcher, then the members."""
    from repro_torch.core.hfuse import BUNDLE
    from repro_torch.kernels.adam import ADAMW
    from repro_torch.kernels.decode_attention import DECODE
    from repro_torch.kernels.moe_gmm import MOE_GMM
    from repro_torch.kernels.paper_suite import KERNELS
    from repro_torch.kernels.prefill_attention import PREFILL
    from repro_torch.kernels.row import ROW
    return (BUNDLE, ROW, DECODE, PREFILL, ADAMW, *KERNELS.values(), MOE_GMM)
