"""The port's CUDA kernels.  Launched through the bundle launcher
(``core/hfuse.py``, source ``csrc/bundle.cu``): the row member family
(RMSNorm, the row GEMM with its prologue and epilogues, the activation, the
residual add), decode attention, prefill attention (both contiguous and
paged), the grouped expert FFN, the AdamW update and the seven paper-suite
bodies.  Launched alone, as their own kernels in the same library: the
tiled matmul and flash attention.  ``kernels/ops.py`` is the public entry
surface over them."""


def registry():
    """The port's hand-written kernels, in report order: the bundle
    launcher, its members, then the standalone kernels."""
    from repro_torch.core.hfuse import BUNDLE
    from repro_torch.kernels.adam import ADAMW
    from repro_torch.kernels.decode_attention import DECODE
    from repro_torch.kernels.flash_attention import FLASH
    from repro_torch.kernels.matmul import TILED_MATMUL
    from repro_torch.kernels.moe_gmm import MOE_GMM
    from repro_torch.kernels.paper_suite import KERNELS
    from repro_torch.kernels.prefill_attention import PREFILL
    from repro_torch.kernels.row import ROW
    return (BUNDLE, ROW, DECODE, PREFILL, ADAMW, *KERNELS.values(), MOE_GMM,
            TILED_MATMUL, FLASH)
