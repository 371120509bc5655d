"""Share of the traced training window in which the device ran nothing (%)."""
from h100bench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
