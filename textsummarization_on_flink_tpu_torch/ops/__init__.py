"""Tensor ops of the port: LSTM, attention, and the fused attention kernel."""


def launch_counts() -> dict:
    """Every kernel wrapper's launch count in this process: the fused
    attention's forward and backward (and of those, the launches on a
    bf16 encoder stream, of the slab form at widths the dense form does
    not fit, and of the sp-block form), the flash forward, dK/dV and dQ
    (and of those, the launches of their bf16 forms, of the wide
    kernels that run head dims above 256 and of the wide kernels'
    cluster forms, and on a block of query rows shorter than the
    keys)."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl
    from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa

    return dict(fused=fa.launches, fused_bwd=fa.launches_bwd,
                fused_bf16=fa.launches_bf16,
                fused_bwd_bf16=fa.launches_bwd_bf16,
                fused_slab=fa.launches_slab,
                fused_bwd_slab=fa.launches_bwd_slab,
                fused_sp=fa.launches_sp, fused_bwd_sp=fa.launches_bwd_sp,
                flash_forward=fl.launches, flash_bwd_dkv=fl.launches_bwd_dkv,
                flash_bwd_dq=fl.launches_bwd_dq,
                flash_forward_bf16=fl.launches_bf16,
                flash_bwd_dkv_bf16=fl.launches_bwd_dkv_bf16,
                flash_bwd_dq_bf16=fl.launches_bwd_dq_bf16,
                flash_forward_wide=fl.launches_wide,
                flash_bwd_dkv_wide=fl.launches_bwd_dkv_wide,
                flash_bwd_dq_wide=fl.launches_bwd_dq_wide,
                flash_forward_wide_cluster=fl.launches_wide_cluster,
                flash_bwd_dkv_wide_cluster=fl.launches_bwd_dkv_wide_cluster,
                flash_bwd_dq_wide_cluster=fl.launches_bwd_dq_wide_cluster,
                flash_forward_block=fl.launches_block,
                flash_bwd_dkv_block=fl.launches_bwd_dkv_block,
                flash_bwd_dq_block=fl.launches_bwd_dq_block)
