"""Checkpoint/resume for SVI state: one .npz plus the config JSON.

The reference's only resume path is reloading the saved text model
(SURVEY.md §5); here a checkpoint holds the full SVIState — gamma,
lambda, the step counter and the base key's data — in `state.npz`, and
the run's `config.json`. A resumed run continues bitwise-identically:
the RNG is a fold_in of (seed, step), so there is no sampler state
beyond the step counter (SURVEY.md §7.4 RNG discipline).

Multi-process runs: the arrays are gathered to every process, process 0
writes, and every process reads the file back and places its own shards
(`sharding_fn`).
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import jax
import numpy as np

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.svi.engine import SVIState

_STATE_FILE = "state.npz"
_CONFIG_FILE = "config.json"

_pending: Optional[threading.Thread] = None
_error: list = []


def wait_until_finished() -> None:
    """Block until any in-flight background save has been written;
    re-raise the error it hit, if any."""
    global _pending
    if _pending is not None:
        _pending.join()
        _pending = None
    if _error:
        raise _error.pop()


def _host_arrays(state: SVIState) -> dict:
    key = state.key
    typed = jax.dtypes.issubdtype(key.dtype, jax.dtypes.prng_key)
    if typed:
        key = jax.random.key_data(key)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        gamma, lamb = multihost_utils.process_allgather(
            (state.gamma, state.lamb), tiled=True)
    else:
        gamma, lamb = jax.device_get((state.gamma, state.lamb))
    return dict(gamma=np.asarray(gamma), lamb=np.asarray(lamb),
                t=np.asarray(jax.device_get(state.t), np.int32),
                key=np.asarray(jax.device_get(key), np.uint32),
                typed_key=np.asarray(typed))


def _write(path: str, arrays: dict, cfg_json: str) -> None:
    tmp = os.path.join(path, _STATE_FILE + ".tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(path, _STATE_FILE))
    with open(os.path.join(path, _CONFIG_FILE), "w") as f:
        f.write(cfg_json)


def save_checkpoint(path: str, state: SVIState, cfg: SVIConfig,
                    block: bool = True) -> None:
    """Save the SVIState + config.

    The arrays are copied to the host first (`jax.device_get`), so the
    caller may go on stepping. block=False then writes the file on a
    background thread: periodic mid-run saves do not stall the step loop.
    At most one save is in flight (a new save first waits out the
    previous one); call wait_until_finished() before reading the
    checkpoint back."""
    global _pending
    wait_until_finished()
    path = os.path.abspath(path)
    arrays = _host_arrays(state)
    if jax.process_index() != 0:
        return
    os.makedirs(path, exist_ok=True)

    def run():
        try:
            _write(path, arrays, cfg.to_json())
        except BaseException as e:  # surfaced by wait_until_finished
            _error.append(e)

    if block:
        _write(path, arrays, cfg.to_json())
    else:
        _pending = threading.Thread(target=run, daemon=True)
        _pending.start()


def restore_checkpoint(
    path: str, *, sharding_fn=None
) -> tuple[SVIState, SVIConfig]:
    """Restore (state, config). `sharding_fn(name, arr)` may device_put
    each array with the desired NamedSharding (multi-host resume)."""
    wait_until_finished()          # a pending background save may be ours
    path = os.path.abspath(path)
    with open(os.path.join(path, _CONFIG_FILE)) as f:
        cfg = SVIConfig.from_json(f.read())
    with np.load(os.path.join(path, _STATE_FILE)) as z:
        raw = {k: z[k] for k in z.files}
    key = raw["key"]
    if bool(raw["typed_key"]):
        key = jax.random.wrap_key_data(key)
    arrays = {k: raw[k] for k in ("gamma", "lamb")}
    if sharding_fn is not None:
        arrays = {k: sharding_fn(k, v) for k, v in arrays.items()}
    state = SVIState(
        gamma=arrays["gamma"],
        lamb=arrays["lamb"],
        t=raw["t"].astype(np.int32)[()],
        key=key,
    )
    return state, cfg
