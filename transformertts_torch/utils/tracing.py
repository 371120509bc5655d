"""Spans and counters of the serving path, kept in memory, on the host's
epoch clock.

    from transformertts_torch.utils import tracing
    tracing.enable()
    wavs = synthesize_lines(model, audio, lines)
    records = tracing.take()      # {'spans': [...], 'counters': {...}}
    tracing.disable()

A span is a dict: ``name``, ``start_ns`` and ``end_ns`` (``time.time_ns()``),
``parent`` (the index in the same list of the span that was open when it
opened, or None), ``request`` (one id for a root span and everything opened
inside it: one ``synthesize_lines`` call) and ``attrs``. ``time.time_ns()``
is the clock of ``torch.profiler``'s exported trace, whose event ``ts`` in
µs is (epoch ns − ``baseTimeNanoseconds``) / 1e3, so the spans lie on the
same timeline as the kernels and their launches. Counters are sums of host
numbers over the enabled period.

Off (the default), ``span`` returns the shared ``NO_SPAN`` and reads no
clock, and ``count`` returns after one flag test. On, a span appends a dict
to a list; nothing here touches the device. One thread: the spans of the
serving loop nest as its calls do. Call ``take`` with no span open.
"""
import itertools
import json
import os
import time

_clock = time.time_ns

_on = False
_spans = []
_open = []          # indices into _spans of the open spans, innermost last
_counters = {}
_request_ids = itertools.count()


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def enabled() -> bool:
    return _on


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ('record',)

    def __init__(self, name: str, attrs: dict):
        self.record = {'name': name, 'start_ns': None, 'end_ns': None, 'parent': None,
                       'request': None, 'attrs': attrs}

    def __enter__(self):
        rec = self.record
        if _open:
            rec['parent'] = _open[-1]
            rec['request'] = _spans[_open[-1]]['request']
        else:
            rec['request'] = next(_request_ids)
        _open.append(len(_spans))
        _spans.append(rec)
        rec['start_ns'] = _clock()
        return self

    def __exit__(self, *exc):
        self.record['end_ns'] = _clock()
        _open.pop()
        return False

    def set(self, **attrs):
        """Attributes known only once the span is open."""
        self.record['attrs'].update(attrs)


def span(name: str, **attrs):
    """A context manager timing its body as the span ``name``."""
    if not _on:
        return NO_SPAN
    return _Span(name, attrs)


def count(name: str, n: int = 1):
    if not _on:
        return
    _counters[name] = _counters.get(name, 0) + n


def take() -> dict:
    """The spans and counters recorded since the last ``take``, cleared."""
    global _spans, _counters
    out = {'spans': _spans, 'counters': _counters}
    _spans, _counters = [], {}
    return out


def write_chrome_trace(path, records: dict):
    """``records`` (``take()``'s) as a Chrome-trace JSON: one complete event
    a span, its attrs and request id as args, the counters under
    ``counters``. Its ``baseTimeNanoseconds`` means what it means in
    ``torch.profiler``'s export (``ts`` µs = (epoch ns − base) / 1e3), so a
    profiler trace of the same run is laid over it by shifting one file's
    ``ts`` by the difference of the two bases."""
    spans = records['spans']
    base = min((s['start_ns'] for s in spans), default=0)
    pid = os.getpid()
    events = [{'name': s['name'], 'ph': 'X', 'pid': pid, 'tid': 'synthesize_lines',
               'ts': (s['start_ns'] - base) / 1e3, 'dur': (s['end_ns'] - s['start_ns']) / 1e3,
               'args': dict(s['attrs'], request=s['request'])} for s in spans]
    with open(path, 'w') as f:
        json.dump({'traceEvents': events, 'displayTimeUnit': 'ms',
                   'baseTimeNanoseconds': base, 'counters': records['counters']}, f)
