"""The whole serving window's share of the card's peak (%): the least time
its work needs (``readers.serve_flop_seconds``: the model at the bfloat16
peak, the waveform stage at the float32 one) over the window's time."""
from h100bench.readers import serve_flop_seconds


def read(ctx):
    if not ctx['a_work'] or ctx['a']['window_s'] <= 0:
        return None
    return 100.0 * serve_flop_seconds(ctx) / ctx['a']['window_s']
