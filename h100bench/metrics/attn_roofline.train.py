"""K2–K4's share of their roofline over the training window (%): Σ bound
time over Σ device time of every launch of the attention forward, dQ and
dK/dV kernels."""
from h100bench.readers import kernel_seconds, train_attention_bound_s


def read(ctx):
    spent = kernel_seconds(ctx, ('attn_fwd', 'attn_dq', 'attn_dkv'))
    if spent <= 0:
        return None
    return 100.0 * train_attention_bound_s(ctx) / spent
