"""Model families of the serving cells. A serving configuration's
``model_family`` names ``families/<model_family>.py`` (a Python module
name), which gives the serving driver (``serve.py``) everything that
depends on the model:

- ``build(cfg, mix, seed, device) -> dict``: the program on ``device`` with
  weights drawn from the seed; the dict holds at least ``weights`` (what
  ``judge`` and ``control_records`` take, never the program's own state)
  and ``sampling_rate``;
- ``serve(built, sentences, mix) -> wavs``: one request, the call the window
  times;
- ``Capture(built)``: hooks recording, without a device sync, what each
  chunk of a request was fed and produced; ``take()`` returns and clears
  the current request's chunks, ``close()`` removes the hooks;
- ``chunk_work(chunk)``: what the per-layer readers keep of one captured
  chunk in ``ctx['a_work']``;
- ``records(sentences, wavs, chunks) -> list``: one checked record a
  sentence, on the host;
- ``judge(records, cfg, weights) -> dict`` (with ``checked_sentences``) and
  ``control_records(sentences, cfg, weights) -> list``: the check against
  the family's reference and its control one precision below;
- ``stage(built) -> (owner, attribute)``: the callable whose calls make the
  waveform stage, timed on the card by ``serve.StageClock``;
- ``flop_seconds(ctx)``: the least device seconds of window A's work, for
  ``mfu.serve``;
- ``attention_bound_s``: ``ctx -> seconds``, the K1 bound of window A's
  launches, for ``attn_roofline.serve``; ``None`` where the family launches
  no K1.
"""
