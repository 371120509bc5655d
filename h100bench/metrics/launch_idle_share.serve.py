"""Share of the traced serving window in which the device ran nothing while
the host's innermost open span of the program was ``encode``, ``decode`` or
``waveform`` (%): the launch gaps that launching faster could win back
(``spans.launch_idle_share``: each idle interval of window A cut at the
program's span boundaries)."""
from h100bench.spans import launch_idle_share


def read(ctx):
    return launch_idle_share(ctx)
