"""Deterministic fault injection for chaos-testing the round engine; a
copy of repro/core/faults.py (numpy only: the reference's package
imports JAX on load, so the port keeps its own copy, draw for draw).

A ``FaultPlan`` is a SEEDED, STATELESS description of every fault a run
will experience: each query is a pure function of (plan seed, injector
salt, round index), so the same plan replays bit-identically across the
sync and async engines, with no sequential stream to desynchronize.

Injector classes (the registry, ``FAULT_KINDS``):

  nan_delta       client delta filled with NaN after local training
  explode_delta   client delta multiplied by ``magnitude`` (norm blow-up)
  client_hang     client latency boosted past any round deadline
  ingest_crash    staging producer raises before sampling round t
  ckpt_corrupt    checkpoint step written corrupted (truncate / bitflip /
                  missing digest sidecar), applied by ``corrupt_checkpoint``
  edge_drop       an EDGE aggregator (one host's cohort slice) drops
                  mid-round and its summary never reaches the server

The first two surface as ``delta_codes`` consumed by the round
(core/round.py ``apply_fault_codes``, a (K,) int32 input); hangs surface
as a ``latency_boost`` added to the runtime model's draw at sampling
time. The port's trainer has no consumer yet for ingest crashes (no
supervised prefetcher), corrupted checkpoints (no checkpoints) or edge
drops (no edges), and refuses a plan that holds them (core/api.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Type

import numpy as np

# delta fault codes, consumed by core/round.py's injection input
CODE_OK = 0
CODE_NAN = 1
CODE_EXPLODE = 2

# latency added to a hung client's runtime draw: past any finite deadline
HANG_LATENCY = 1e9


# ---------------- injector registry ----------------

FAULT_KINDS: Dict[str, Type["FaultInjector"]] = {}


def register_fault(cls: Type["FaultInjector"]) -> Type["FaultInjector"]:
    if cls.kind in FAULT_KINDS:
        raise ValueError(f"fault kind {cls.kind!r} already registered")
    FAULT_KINDS[cls.kind] = cls
    return cls


@dataclass(frozen=True)
class FaultInjector:
    """One fault class: fires on ``rounds`` (empty = seeded by ``rate``
    per round), targeting ``clients`` (empty = seeded per sampled
    client). Frozen + pure: all randomness is re-derived per query."""
    kind: str = ""
    rate: float = 0.0                    # per-client (or per-round) P(fire)
    rounds: Tuple[int, ...] = ()         # explicit rounds; () = all rounds
    clients: Tuple[int, ...] = ()        # explicit client ids; () = seeded
    magnitude: float = 1e12              # explode multiplier / corrupt arg

    def _round_active(self, t: int) -> bool:
        return not self.rounds or t in self.rounds

    def _rng(self, seed: int, t: int) -> np.random.Generator:
        # per-(plan, kind, round) stream: stateless, order-independent
        salt = int(np.frombuffer(self.kind.encode().ljust(8, b"\0")[:8],
                                 np.uint64)[0] & 0x7FFFFFFF)
        return np.random.default_rng((int(seed), salt, int(t)))

    def client_hits(self, seed: int, t: int,
                    sampled: np.ndarray) -> np.ndarray:
        """(k,) bool mask over the round's sampled client ids."""
        sampled = np.asarray(sampled)
        if not self._round_active(t):
            return np.zeros(sampled.shape, bool)
        if self.clients:
            return np.isin(sampled, np.asarray(self.clients))
        if self.rate <= 0.0:
            return np.zeros(sampled.shape, bool)
        # seeded per CLIENT ID (not per row) so the hit set is invariant
        # to sampling order and identical across sync/async regimes
        rng = self._rng(seed, t)
        u = rng.random(int(np.max(sampled, initial=0)) + 1)
        return u[sampled] < self.rate

    def round_fires(self, seed: int, t: int) -> bool:
        if not self._round_active(t):
            return False
        if self.rounds:                  # explicit rounds always fire
            return True
        return self.rate > 0.0 and self._rng(seed, t).random() < self.rate


@register_fault
@dataclass(frozen=True)
class NaNDelta(FaultInjector):
    kind: str = "nan_delta"


@register_fault
@dataclass(frozen=True)
class ExplodeDelta(FaultInjector):
    kind: str = "explode_delta"


@register_fault
@dataclass(frozen=True)
class ClientHang(FaultInjector):
    kind: str = "client_hang"


@register_fault
@dataclass(frozen=True)
class IngestCrash(FaultInjector):
    kind: str = "ingest_crash"


@register_fault
@dataclass(frozen=True)
class CkptCorrupt(FaultInjector):
    kind: str = "ckpt_corrupt"
    mode: str = "truncate"               # truncate | bitflip | drop_digest


@register_fault
@dataclass(frozen=True)
class EdgeDrop(FaultInjector):
    """Process-loss / mesh-partition injector: ``clients`` doubles as
    explicit EDGE indices (0..E-1); ``rate`` seeds per edge per round.
    The queried id space is the edge index, so the hit set is invariant
    to which clients each edge happens to hold."""
    kind: str = "edge_drop"


# ---------------- the plan ----------------

@dataclass(frozen=True)
class FaultPlan:
    """Seeded bundle of injectors with the query surface the engine
    consumes. Stateless: every method is a pure function of
    (seed, round) so replay under save/resume is automatic."""
    seed: int = 0
    injectors: Tuple[FaultInjector, ...] = ()
    explode_magnitude: float = 1e12

    @classmethod
    def seeded(cls, seed: int, *, nan_rate: float = 0.0,
               explode_rate: float = 0.0, hang_rate: float = 0.0,
               ingest_crash_rate: float = 0.0,
               nan_rounds: Sequence[int] = (), nan_clients: Sequence[int] = (),
               explode_rounds: Sequence[int] = (),
               explode_clients: Sequence[int] = (),
               hang_rounds: Sequence[int] = (),
               hang_clients: Sequence[int] = (),
               ingest_crash_rounds: Sequence[int] = (),
               edge_drop_rate: float = 0.0,
               edge_drop_rounds: Sequence[int] = (),
               edge_drop_edges: Sequence[int] = (),
               explode_magnitude: float = 1e12) -> "FaultPlan":
        inj = []
        if nan_rate or nan_rounds or nan_clients:
            inj.append(NaNDelta(rate=nan_rate, rounds=tuple(nan_rounds),
                                clients=tuple(nan_clients)))
        if explode_rate or explode_rounds or explode_clients:
            inj.append(ExplodeDelta(rate=explode_rate,
                                    rounds=tuple(explode_rounds),
                                    clients=tuple(explode_clients),
                                    magnitude=explode_magnitude))
        if hang_rate or hang_rounds or hang_clients:
            inj.append(ClientHang(rate=hang_rate, rounds=tuple(hang_rounds),
                                  clients=tuple(hang_clients)))
        if ingest_crash_rate or ingest_crash_rounds:
            inj.append(IngestCrash(rate=ingest_crash_rate,
                                   rounds=tuple(ingest_crash_rounds)))
        if edge_drop_rate or edge_drop_rounds or edge_drop_edges:
            inj.append(EdgeDrop(rate=edge_drop_rate,
                                rounds=tuple(edge_drop_rounds),
                                clients=tuple(edge_drop_edges)))
        return cls(seed=seed, injectors=tuple(inj),
                   explode_magnitude=explode_magnitude)

    def _of(self, kind: str):
        return [i for i in self.injectors if i.kind == kind]

    @property
    def active(self) -> bool:
        return bool(self.injectors)

    @property
    def injects_deltas(self) -> bool:
        return bool(self._of("nan_delta") or self._of("explode_delta"))

    def delta_codes(self, t: int, sampled: np.ndarray) -> np.ndarray:
        """(k,) int32 codes for the round's sampled clients — consumed by
        the jit'd round's injection input. NaN wins over explode when an
        id is targeted by both."""
        sampled = np.asarray(sampled)
        codes = np.zeros(sampled.shape, np.int32)
        for inj in self._of("explode_delta"):
            codes[inj.client_hits(self.seed, t, sampled)] = CODE_EXPLODE
        for inj in self._of("nan_delta"):
            codes[inj.client_hits(self.seed, t, sampled)] = CODE_NAN
        return codes

    def delta_targets(self, t: int, sampled: np.ndarray) -> np.ndarray:
        """(k,) bool: the plan's quarantine target set for round t — what
        a correct guard must flag (acceptance oracle for tests/CI)."""
        return self.delta_codes(t, sampled) != CODE_OK

    def latency_boost(self, t: int, sampled: np.ndarray) -> np.ndarray:
        """(k,) f64 added to the runtime model's latency draw."""
        sampled = np.asarray(sampled)
        boost = np.zeros(sampled.shape, np.float64)
        for inj in self._of("client_hang"):
            boost[inj.client_hits(self.seed, t, sampled)] = HANG_LATENCY
        return boost

    @property
    def injects_edges(self) -> bool:
        return bool(self._of("edge_drop"))

    def edge_drops(self, t: int, num_edges: int) -> np.ndarray:
        """(E,) bool — edges whose summary never reaches the server this
        round. Pure in (seed, round), like every other query: the same
        plan replays the same partitions under save/resume and across
        prefetch depths. The engine folds a dropped edge's rows out of
        ``client_mask`` (DESIGN.md §15), so the server aggregates the
        surviving E-1 summaries with zero rule changes."""
        drops = np.zeros(int(num_edges), bool)
        for inj in self._of("edge_drop"):
            drops |= inj.client_hits(self.seed, t, np.arange(num_edges))
        return drops

    def ingest_crash(self, t: int, attempt: int = 0) -> bool:
        """Crash the staging producer for round t?  Only the FIRST
        attempt crashes: the supervised retry re-derives this with
        attempt=1+ and proceeds — bounded recovery by construction."""
        if attempt > 0:
            return False
        return any(i.round_fires(self.seed, t)
                   for i in self._of("ingest_crash"))

    def ckpt_corruption(self, step: int) -> Optional[str]:
        """Corruption mode ('truncate'|'bitflip'|'drop_digest') for the
        checkpoint written at ``step``, or None. Applied by the
        test/bench harness via ``corrupt_checkpoint``."""
        for inj in self._of("ckpt_corrupt"):
            if inj.round_fires(self.seed, step):
                return getattr(inj, "mode", "truncate")
        return None

    # ---- checkpoint echo ----

    def config_dict(self) -> dict:
        return {"seed": self.seed,
                "explode_magnitude": self.explode_magnitude,
                "injectors": [dataclasses.asdict(i) for i in self.injectors]}

    @classmethod
    def from_config(cls, cfg: dict) -> "FaultPlan":
        inj = []
        for d in cfg.get("injectors", []):
            d = dict(d)
            kind = d.pop("kind")
            for k in ("rounds", "clients"):
                d[k] = tuple(d.get(k, ()))
            inj.append(FAULT_KINDS[kind](kind=kind, **d))
        return cls(seed=cfg["seed"], injectors=tuple(inj),
                   explode_magnitude=cfg.get("explode_magnitude", 1e12))


def corrupt_checkpoint(ckpt_dir: str, step: int, mode: str) -> str:
    """Damage the checkpoint at ``step`` in place (test/bench harness for
    the ckpt_corrupt injector): 'truncate' chops state.npz mid-file,
    'bitflip' flips one byte in it, 'drop_digest' deletes the manifest
    sidecar that carries the content digests. Returns the damaged path."""
    import os
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    state = os.path.join(d, "state.npz")
    if mode == "truncate":
        n = os.path.getsize(state)
        with open(state, "r+b") as fh:
            fh.truncate(max(1, n // 2))
        return state
    if mode == "bitflip":
        with open(state, "r+b") as fh:
            fh.seek(os.path.getsize(state) // 2)
            b = fh.read(1)
            fh.seek(-1, 1)
            fh.write(bytes([b[0] ^ 0xFF]))
        return state
    if mode == "drop_digest":
        manifest = os.path.join(d, "manifest.json")
        os.remove(manifest)
        return manifest
    raise ValueError(f"unknown corruption mode {mode!r}")
