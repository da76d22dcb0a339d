"""Traffic mixes, found by name.

A mix is a data file of parameters, benchmark/traffic/<name>.json,
whose "client" key names the code that drives it,
benchmark/clients/<client>.py. A client module has

    KEYS     the parameters it reads (every key of the file but
             "client"); a file with another key, or without one of
             these, is refused
    Client   Client(params, cfg, arrays, generator, device, overrides),
             the system under test behind one load generator:
               warm()            the window's shapes, untimed
               traced_request()  (a call the traced window covers, its
                                 images)
               window(seconds)   the measured window (loop.Timed)
               close()           the program's state freed
               readings(ref, rng)
                                 after the window: one dict of numbers
                                 compared with the reference (`ref`,
                                 the configuration's reference module)
                                 per answer checked
             (benchmark/lib/loop.py has the closed loop these build
             on, benchmark/lib/detection.py the detector's clients)

so that a mix with new parameters or a new kind of request is added as
files, a data file and, where no client drives it yet, a client.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple


def path(bench_dir: Path, name: str) -> Path:
    return bench_dir / "traffic" / f"{name}.json"


def client_path(bench_dir: Path, client: str) -> Path:
    return bench_dir / "clients" / f"{client}.py"


def load(bench_dir: Path, name: str, overrides: Optional[dict] = None) -> Tuple[dict, object]:
    """(parameters, client module) of the mix `name`; `overrides`
    replace parameters (the tests' small pools)."""
    from . import spec

    params = {**json.loads(path(bench_dir, name).read_text()), **(overrides or {})}
    client = spec.check_name(params.pop("client", None), f"traffic {name}: client")
    mod = spec.load_module(client_path(bench_dir, client), f"client_{client}")
    if set(params) != set(mod.KEYS):
        raise spec.SpecError(f"traffic {name}: keys {sorted(params)} are not client "
                             f"{client}'s {sorted(mod.KEYS)}")
    return params, mod
