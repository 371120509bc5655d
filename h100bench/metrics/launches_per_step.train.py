"""Kernel launches a training step over the device-traced window: what the
host issues for each step."""


def read(ctx):
    steps = len(ctx['a_work'])
    return ctx['a']['launches'] / steps if steps else None
