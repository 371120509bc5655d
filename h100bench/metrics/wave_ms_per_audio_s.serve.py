"""Device milliseconds of the waveform stage (Griffin-Lim's mel inversion
and iterations, or the vocoder) per second of audio returned, over the
device-traced window A: each chunk's stage timed on the card by CUDA events
at its entry and return (``serve.StageClock``)."""


def read(ctx):
    audio_s = sum(r['audio_s'] for r in ctx['a_work'])
    spent = ctx['a'].get('wave_stage_s', 0.0)
    if audio_s <= 0 or spent <= 0:
        return None
    return 1e3 * spent / audio_s
