"""The whole training window's share of the card's peak (%): the least time
its steps need at the float32 peak (``readers.train_flop_seconds``) over the
window's time."""
from h100bench.readers import train_flop_seconds


def read(ctx):
    if not ctx['a_work'] or ctx['a']['window_s'] <= 0:
        return None
    return 100.0 * train_flop_seconds(ctx) / ctx['a']['window_s']
