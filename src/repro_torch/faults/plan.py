"""The fault plan: named injection sites firing on a deterministic schedule
(port of repro/faults/plan.py).

A :class:`FaultSpec` schedules one seam: ``site`` names the injection point
(the catalog is in :mod:`repro_torch.faults`), ``steps`` lists the
step / wave / flush indices it fires on, and ``params`` carries the site's
knobs (``fails`` for transient-error counts, ``attempts`` for the retry
budget, ``stall_s`` for stalls, ``ops`` for the kernel site, ``scale`` for
``alpt.delta``, ``seed`` for ``codestore.corrupt``).  A :class:`FaultPlan`
is a seeded set of specs with a JSON round trip, so a chaos run replays
from one file; the JSON is the reference's, so a plan written by either
package loads in the other.

Installation is process-global (the seams live inside trainers, stores and
engines that take no plan argument); :func:`uninstall` or
``install(None)`` clears it.  Every seam consults the plan on the host, per
wave or per call.  The reference's ``step_mask`` builds a traced mask for
its jitted step; the port's step is eager, so :func:`step_mask` is a host
predicate over the same static ``steps``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import zlib
from typing import Any, Callable


class InjectedFault(Exception):
    """Base class for every error this package raises on purpose."""


class TransientFault(InjectedFault):
    """An injected failure the seam is expected to retry through."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled seam: fire ``site`` on each step / wave in ``steps``."""

    site: str
    steps: tuple[int, ...] = ()
    #: Fire on every step / wave (schedules with unknown horizons).
    always: bool = False
    params: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "steps", tuple(int(s) for s in self.steps))

    def fires(self, step: int) -> bool:
        return self.always or int(step) in self.steps

    def param(self, name: str, default=None):
        return self.params.get(name, default)

    def to_json(self) -> dict:
        out: dict[str, Any] = {"site": self.site, "steps": list(self.steps)}
        if self.always:
            out["always"] = True
        if self.params:
            out["params"] = dict(self.params)
        return out

    @classmethod
    def from_json(cls, obj: dict) -> "FaultSpec":
        return cls(site=obj["site"], steps=tuple(obj.get("steps", ())),
                   always=bool(obj.get("always", False)), params=dict(obj.get("params", {})))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, replayable set of scheduled faults (one spec per site)."""

    specs: tuple[FaultSpec, ...] = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))
        sites = [s.site for s in self.specs]
        dup = {s for s in sites if sites.count(s) > 1}
        if dup:
            raise ValueError(f"duplicate fault sites in plan: {sorted(dup)}")

    def lookup(self, site: str) -> FaultSpec | None:
        for spec in self.specs:
            if spec.site == site:
                return spec
        return None

    def fires(self, site: str, step: int) -> bool:
        spec = self.lookup(site)
        return spec is not None and spec.fires(step)

    def sites(self) -> tuple[str, ...]:
        return tuple(s.site for s in self.specs)

    def to_json(self) -> dict:
        return {"seed": self.seed, "specs": [s.to_json() for s in self.specs]}

    @classmethod
    def from_json(cls, obj: dict) -> "FaultPlan":
        return cls(seed=int(obj.get("seed", 0)),
                   specs=tuple(FaultSpec.from_json(s) for s in obj.get("specs", ())))

    def save(self, path: str | os.PathLike) -> None:
        pathlib.Path(path).write_text(json.dumps(self.to_json(), indent=2))

    @classmethod
    def load(cls, path: str | os.PathLike) -> "FaultPlan":
        return cls.from_json(json.loads(pathlib.Path(path).read_text()))


_ACTIVE: FaultPlan | None = None


def install(plan: FaultPlan | None) -> None:
    """Make ``plan`` the process-wide active plan (None clears it)."""
    global _ACTIVE
    _ACTIVE = plan


def uninstall() -> None:
    install(None)


def active_plan() -> FaultPlan | None:
    return _ACTIVE


def lookup(site: str) -> FaultSpec | None:
    """The active plan's spec for ``site`` (None without a plan or a spec)."""
    return None if _ACTIVE is None else _ACTIVE.lookup(site)


def fires(site: str, step: int) -> bool:
    """Whether the active plan fires ``site`` at ``step``."""
    return _ACTIVE is not None and _ACTIVE.fires(site, step)


def step_mask(spec: FaultSpec | None) -> Callable[[int], bool]:
    """``fire(step) -> bool`` from the spec's static schedule: always False
    without a spec (the reference's traced mask, as a host predicate)."""
    if spec is None:
        return lambda step: False
    return spec.fires


def corrupt_checkpoint_leaf(directory: str | os.PathLike, step: int, *, leaf: int = 0,
                            seed: int = 0) -> pathlib.Path:
    """Flip one byte of a committed checkpoint's leaf file, in the data past
    the .npy header (the ``checkpoint.corrupt`` seam); returns its path.

    The byte is the reference's: ``128 + crc32(f"{step}:{leaf}:{seed}") %
    (size - 128)``, so one plan corrupts the same byte in both packages.
    Detection and recovery belong to the checkpoint manager (per-leaf
    checksums, fall back to the last good step).
    """
    path = pathlib.Path(directory) / f"step_{step:09d}" / f"leaf_{leaf:05d}.npy"
    raw = bytearray(path.read_bytes())
    header = 128  # a .npy v1 header is 64-byte aligned; 128 clears any dict
    if len(raw) <= header:
        header = max(0, len(raw) - 1)
    pos = header + zlib.crc32(f"{step}:{leaf}:{seed}".encode()) % (len(raw) - header)
    raw[pos] ^= 0xFF
    path.write_bytes(bytes(raw))
    return path
