"""Traffic mixes, found by name.

A mix is a data file `traffic/<name>.json` of parameters.  Its
`generator` key names the module `traffic/<generator>.py` that reads
them: its `make(name, params)` returns the mix, an object with `source`
(the guest program, the same for every seed) and `job(seed, j)` (the
stdin of job j; j = -1 is the warm-up job).  A mix of a new shape adds a
file, and a generator module where none fits.
"""

from __future__ import annotations

import importlib
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str):
    with open(os.path.join(HERE, name + ".json")) as fh:
        params = json.load(fh)
    gen = importlib.import_module(f"{__name__}.{params['generator']}")
    return gen.make(name, params)
