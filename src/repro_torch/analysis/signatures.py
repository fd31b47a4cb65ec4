"""Shape signatures: the static front half of the compile warm-up.

Port of the part of ``repro/analysis/signatures.py`` that the warm-up
needs.  The planner keeps every emitted shape inside a small, enumerable
pow2-bucket universe (``core/plan_cost.pow2`` for waves, fixed
``[rows, seq_len]`` for the packed batch).  This module

  1. derives each planned step's signatures
     (``core/plan_cost.packed_signature`` / ``wave_signature``) exactly the
     way ``train/engine`` keys its executable lookups
     (``step_signatures``);
  2. checks a signature against the reachable universe
     (``SignatureUniverse.contains``: an out-of-universe signature is a
     stall inside the training loop);
  3. enumerates (counts) the bounded universe: the list the warm-up
     service (``train/warmup``) makes ready ahead of the loop.

The reference's ``lint_signatures`` and its tree sources wait for ROADMAP
Queue A item 7f (the tooling).  Pure host code.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Hashable

from repro_torch.core.plan_cost import (packed_signature, pow2,
                                        round_to_multiple, wave_signature,
                                        wave_signature_of)

__all__ = ["wave_signature_of", "step_signatures", "SignatureUniverse"]


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def step_signatures(ps) -> list[Hashable]:
    """All signatures one PlannedStep will dispatch (packed batch + every
    partition wave)."""
    sigs: list[Hashable] = []
    sb = ps.step_batch()
    if sb.tb is not None:
        B, S = sb.tb.tokens.shape
        sigs.append(packed_signature(B, S))
    plan = ps.execution_plan()
    if plan.partition is not None:
        sigs.extend(wave_signature_of(wp, ps.lc.seq_len)
                    for wp in plan.partition.waves)
    return sigs


@dataclass(frozen=True)
class SignatureUniverse:
    """The reachable signature set for one (LoaderConfig, PlannerConfig)
    pair.  Membership is exact for the packed batch and pow2-bucket-shaped
    for waves; ``count`` bounds the enumeration the warm-up makes ready."""
    seq_len: int
    batch_rows: int
    num_replicas: int
    max_rows: int
    capacity: int

    @property
    def packed_rows(self) -> int:
        return round_to_multiple(self.batch_rows, self.num_replicas)

    @property
    def max_wave_rows(self) -> int:
        R = max(self.num_replicas, 1)
        return R * pow2(-(-self.max_rows // R))

    def contains(self, sig: Hashable) -> tuple[bool, str]:
        kind = sig[0]
        if kind == "packed":
            _, rows, S = sig
            if rows != self.packed_rows:
                return False, (f"packed rows {rows} != replica-rounded "
                               f"batch_rows {self.packed_rows}")
            if S != self.seq_len:
                return False, f"packed seq {S} != {self.seq_len}"
            return True, ""
        if kind == "wave":
            _, rows, S, anc, ncut, plen, n_extra = sig
            R = max(self.num_replicas, 1)
            if S != self.seq_len:
                return False, f"wave seq {S} != {self.seq_len}"
            if rows % R or not _is_pow2(rows // R):
                return False, (f"wave rows {rows} not a pow2 multiple of "
                               f"{R} replicas")
            if rows > self.max_wave_rows:
                return False, (f"wave rows {rows} exceed the max_rows "
                               f"bucket {self.max_wave_rows}")
            if anc and (not _is_pow2(anc) or anc < 8):
                return False, f"ancestor pad {anc} not a pow2 ≥ 8 bucket"
            if ncut and not _is_pow2(ncut):
                return False, f"cut count {ncut} not pow2-bucketed"
            if plen and (not _is_pow2(plen) or plen > pow2(self.capacity)):
                return False, f"path pad {plen} out of pow2 buckets"
            if n_extra and not _is_pow2(n_extra):
                return False, f"extra pad {n_extra} not pow2-bucketed"
            return True, ""
        return False, f"unknown signature kind {kind!r}"

    def count(self, anc_cap: int, ncut_cap: int, plen_cap: int,
              extra_cap: int) -> int:
        """Bounding-box size of the universe under observed per-field
        maxima: 1 packed + every wave bucket combination.  An upper bound
        on :meth:`enumerate_signatures`, the exact list the warm-up
        service makes ready."""
        def nopts(cap: int, lo: int = 1) -> int:
            n, b = 1, lo                       # the 0 bucket
            while b <= cap:
                n, b = n + 1, b * 2
            return n
        R = max(self.num_replicas, 1)
        rows_opts = 0
        b = R
        while b <= self.max_wave_rows:
            rows_opts, b = rows_opts + 1, b * 2
        return 1 + (rows_opts * nopts(anc_cap, 8) * nopts(ncut_cap)
                    * nopts(plen_cap) * nopts(extra_cap))

    def _buckets(self, cap: int, lo: int = 1) -> list[int]:
        out, b = [0], lo
        while b <= cap:
            out.append(b)
            b *= 2
        return out

    def enumerate_signatures(self, anc_cap: int, ncut_cap: int,
                             plen_cap: int, extra_cap: int
                             ) -> list[Hashable]:
        """THE warm-up list: every *live* signature in the universe,
        bounded by observed (or configured) per-field caps.  ``count`` is
        the loose bounding box; this enumeration drops the structurally
        dead corners a real planner run can never emit:

          - ``ncut == 0`` ⟺ ``plen == 0`` ⟺ ``n_extra == 0`` — the
            capture plans drive both the path pad and the boundary-extra
            columns, so the three vanish together (a leaf wave);
          - ``anc == 0 ⇒ ncut ≥ 1`` — a root wave comes from partitioning
            an oversized tree (≥ 2 fragments), so its fragments always
            cut to children; a wave with neither gateway nor cuts would
            be a row-sized tree, which packs instead;
          - ``n_extra ≤ ncut`` — per-row boundary extras are bucketed
            from per-row cut counts, never exceeding the wave total.

        Every returned signature passes :meth:`contains`;
        ``len(result) ≤ count(same caps)``."""
        sigs: list[Hashable] = [packed_signature(self.packed_rows,
                                                 self.seq_len)]
        R = max(self.num_replicas, 1)
        rows_list, b = [], R
        while b <= self.max_wave_rows:
            rows_list.append(b)
            b *= 2
        plen_cap = min(plen_cap, pow2(self.capacity))
        for rows in rows_list:
            for anc in self._buckets(anc_cap, lo=8):
                for ncut in self._buckets(ncut_cap):
                    if ncut == 0:
                        if anc > 0:     # leaf wave: gateway in, no cuts
                            sigs.append(wave_signature(
                                rows, self.seq_len, anc, 0, 0, 0))
                        continue
                    for plen in self._buckets(plen_cap)[1:]:
                        for n_extra in self._buckets(
                                min(extra_cap, ncut))[1:]:
                            sigs.append(wave_signature(
                                rows, self.seq_len, anc, ncut, plen,
                                n_extra))
        return sigs
