"""What the entries share: the contract an entry keeps, and the harness's
span around a layer's call.

An entry is ``entries/<name>.py``, the name a configuration file gives
under ``"entry"``, defining a class ``Entry``: the program's call that a
cell's window drives, and the reference's counterpart of it. The program
is imported in an entry and only there, when the entry is built.
"""

from __future__ import annotations


def span(name, fn):
    """``fn`` inside a profiler range ``bench.<name>``."""
    import torch

    def wrapped(*args, **kw):
        with torch.profiler.record_function("bench." + name):
            return fn(*args, **kw)
    return wrapped


class EntryBase:
    """The contract of ``Entry``:

    * ``Entry(conf, mix, device)``: the program built from the
      configuration file ``conf`` for the traffic mix ``mix``;
    * ``schedule(items)``: (key, item) for ever, the order in which the
      window serves the mix's items;
    * ``warm(items)``: set-up's calls, which serve every shape the window
      will use;
    * ``call(key, item, timings)``: one call of the program, its output as
      host arrays (``check.compare``'s form); ``timings`` a dict in a
      traced run (the program's ``StageClock``), else None;
    * ``spans()``: a context in which the calls into each layer run inside
      harness spans (a traced run);
    * ``reference(ref, mix, items, keys)`` (static): the reference's output
      for each key, ``ref`` a ``reference.engine.Reference``;
    * ``unit``: what one unit of completed work is (the end-to-end readers
      count rates in it: ``"pair"``, ``"frame"``);
    * ``root``: the root span of the one record that a traced call leaves
      in ``icpflow_tpu_torch.trace.calls()``;
    * ``units(key, item)``: how many units a call completes.
    """

    unit: str
    root: str

    def units(self, key, item) -> int:
        return 1
