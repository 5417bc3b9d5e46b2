"""Backend-dispatch registry for the quantised recurrent datapath.

Counterpart of ``repro/backends/__init__.py``.  Three engines are
registered, under the reference's names so one ``AcceleratorConfig``
drives both packages:

  * ``ref``    (``backends/ref.py``) — the plain-torch oracle
               (``kernels/ref.py``): the specification the others must
               match bit for bit;
  * ``pallas`` (``backends/fused.py``) — the hand-written CUDA kernels of
               ``kernels/qlstm_cell.py`` (their plain versions for tensors
               on the CPU); the paper's pipelined ALU with hard
               activations;
  * ``xla``    (``backends/scan.py``) — the general per-step torch engine
               (``core.qlstm.forward_int_stateful``): every Table-2 point,
               including the per-step ALU and the LUT activations.

A backend exposes ``run(qparams, x_int, model, accel) -> y_int``,
``supports(model, accel) -> Optional[str]``, optionally ``layer`` (one
layer, time-major), ``run_stateful(..., state) -> (y_int, new_state)``,
``run_stateful_slots(..., table, gather_slots, scatter_slots) -> (y_int,
new_table)`` (the ``(n_slots + 2, L, S, H)`` table contract of
``kernels/qlstm_cell.qlstm_seq_slot``), and ``prepare(device)``, called
when a session resolves the engine, so that a kernel which cannot be
built fails there and not in the serving tier's guarded execute path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.accelerator import (AcceleratorConfig, resolve_backend,
                                          resolve_model,
                                          resolve_stateful_backend)
from repro_torch.core.qlstm import QLSTMConfig


class BackendUnsupported(ValueError):
    """Raised when an explicitly requested backend cannot execute the
    resolved (model, accelerator) configuration."""


@dataclasses.dataclass(frozen=True)
class Backend:
    """One registered execution engine."""

    name: str
    run: Callable                       # (qparams, x_int, model, accel) -> y_int
    supports: Callable                  # (model, accel) -> Optional[str]
    layer: Optional[Callable] = None    # (x_int, wx, wh, b, model, accel) -> h_seq
    run_stateful: Optional[Callable] = None
    run_stateful_slots: Optional[Callable] = None
    # (device) -> None: build what the engine launches on ``device``.
    prepare: Optional[Callable] = None


_REGISTRY: Dict[str, Backend] = {}


def register(backend: Backend) -> Backend:
    """Add an engine to the registry and return it."""
    _REGISTRY[backend.name] = backend
    return backend


def get(name: str) -> Backend:
    """The registered engine under ``name``; KeyError names the known
    engines when it does not exist."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def available() -> Tuple[str, ...]:
    """Names of every registered engine, sorted."""
    return tuple(sorted(_REGISTRY))


def select(model: QLSTMConfig, accel: AcceleratorConfig,
           override: Optional[str] = None) -> Backend:
    """Resolve the backend for a configuration: an explicit ``override``
    (or non-``auto`` ``accel.backend``) verbatim, raising
    :class:`BackendUnsupported` if it cannot run the configuration;
    ``auto`` asks the plan."""
    model = resolve_model(model, accel, warn=False)
    name = override if override not in (None, "auto") \
        else resolve_backend(model, accel)
    backend = get(name)
    reason = backend.supports(model, accel)
    if reason is not None:
        raise BackendUnsupported(
            f"backend {name!r} cannot run this configuration: {reason}")
    return backend


def supported_backends(model: QLSTMConfig,
                       accel: AcceleratorConfig) -> Tuple[str, ...]:
    """Names of every registered backend able to run the configuration."""
    model = resolve_model(model, accel, warn=False)
    return tuple(n for n in available()
                 if _REGISTRY[n].supports(model, accel) is None)


def _stateful_reason(backend: Backend, model: QLSTMConfig,
                     accel: AcceleratorConfig) -> Optional[str]:
    reason = backend.supports(model, accel)
    if reason is not None:
        return reason
    if backend.run_stateful is None:
        return ("no stateful entry point (the engine cannot carry state "
                "across windows)")
    return None


def select_stateful(model: QLSTMConfig, accel: AcceleratorConfig,
                    override: Optional[str] = None) -> Backend:
    """:func:`select` for engines that carry recurrent state across
    windows; ``auto`` follows the plan's ``stateful_backend``."""
    model = resolve_model(model, accel, warn=False)
    name = override if override not in (None, "auto") \
        else resolve_stateful_backend(model, accel)
    backend = get(name)
    reason = _stateful_reason(backend, model, accel)
    if reason is not None:
        raise BackendUnsupported(
            f"backend {name!r} cannot run this configuration statefully: "
            f"{reason}")
    return backend


def stateful_backends(model: QLSTMConfig,
                      accel: AcceleratorConfig) -> Tuple[str, ...]:
    """Names of every engine able to run the configuration statefully."""
    model = resolve_model(model, accel, warn=False)
    return tuple(n for n in available()
                 if _stateful_reason(_REGISTRY[n], model, accel) is None)


# Fastest-first engine order for graceful degradation.  All three are
# bit-identical on the int path, so moving down the ladder changes
# latency, never results.
DEGRADATION_ORDER = ("pallas", "xla", "ref")


def degradation_ladder(model: QLSTMConfig, accel: AcceleratorConfig,
                       override: Optional[str] = None,
                       stateful: bool = True,
                       device: Optional[torch.device] = None
                       ) -> Tuple[str, ...]:
    """Ordered engine names the serving tier degrades through: the
    resolved (or ``override``-requested) engine first, then every other
    capable engine in :data:`DEGRADATION_ORDER`.

    On a CUDA ``device`` the ladder ends at ``pallas``: a fused kernel
    that fails to launch fails the wave instead of being served by a
    plain torch engine, which would hide the failure behind a correct
    answer.  On the CPU ``pallas`` runs the kernels' plain versions, so
    the full ladder stays."""
    first = (select_stateful if stateful else select)(
        model, accel, override=override).name
    capable = (stateful_backends if stateful else supported_backends)(
        model, accel)
    rest = [n for n in DEGRADATION_ORDER if n in capable and n != first]
    rest += [n for n in capable
             if n not in DEGRADATION_ORDER and n != first]
    ladder = (first, *rest)
    if device is not None and torch.device(device).type == "cuda" \
            and "pallas" in ladder:
        ladder = ladder[:ladder.index("pallas") + 1]
    return ladder


# Importing the submodules registers the engines.
from repro_torch.backends import fused as _fused  # noqa: E402,F401
from repro_torch.backends import ref as _ref      # noqa: E402,F401
from repro_torch.backends import scan as _scan    # noqa: E402,F401
