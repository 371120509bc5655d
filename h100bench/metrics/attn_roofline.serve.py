"""K1's share of its roofline over the serving window (%): Σ bound time
over Σ device time of every K1 launch (the kernels named ``attn_fwd``), the
bound as the model family counts it."""
from h100bench.readers import kernel_seconds, serve_attention_bound_s


def read(ctx):
    spent = kernel_seconds(ctx, ('attn_fwd',))
    if spent <= 0:
        return None
    bound = serve_attention_bound_s(ctx)
    return None if bound is None else 100.0 * bound / spent
