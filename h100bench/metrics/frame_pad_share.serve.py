"""Share of the frame slots of window A's chunks that are padding (%): 100 ×
(1 − frames_real / frame_slots), from the program's counters
(``spans.frame_pad_share``). The decoder and the waveform stage compute
every slot."""
from h100bench.spans import frame_pad_share


def read(ctx):
    return frame_pad_share(ctx)
