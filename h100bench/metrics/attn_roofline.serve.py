"""K1's share of its roofline over the serving window (%): Σ bound time
over Σ device time of every K1 launch (the kernels named ``attn_fwd``)."""
from h100bench.readers import kernel_seconds, serve_attention_bound_s


def read(ctx):
    spent = kernel_seconds(ctx, ('attn_fwd',))
    if spent <= 0:
        return None
    return 100.0 * serve_attention_bound_s(ctx) / spent
