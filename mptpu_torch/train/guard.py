"""Host-side divergence-storm policy of the SIAM trainers (counterpart of
``mptpu/train/guard.py``; pure Python, kept here as a copy so that the
port imports nothing of ``mptpu``).

The trainer owns the expensive parts (restoring parameters and optimiser
state, halving ``lr_mult``, clearing handoff tails); the guard owns every
decision:

1. A spike is relative AND absolute: gnorm > ``rel`` x median of the
   recent clean history AND > ``abs_mult`` x the clip level.
2. A single finite spike is tolerated; a second spike within
   ``near_window`` checks that grew ``escalation_growth``-fold is an
   escalating train and counts as poisoning (rollback).
3. Non-finite stats, a loss above the catastrophe threshold, or a
   non-finite-forward flag are poisoning outright.
4. Snapshot promotion is gated in hindsight: a state captured at a
   healthy boundary becomes the rollback target only after its boundary
   window passed with no escalation; isolated single spikes do not block
   it.
5. A candidate is captured only at a boundary with no spike within
   ``near_window``.
6. The consecutive-rollback abort counter resets on promotion and on
   progress ``progress_margin`` steps past the rollback target. The
   trainer's loop index never rewinds after a rollback, so on a run that
   keeps falling off one cliff the second reset fires at every healthy
   boundary once the index is that far past the target, and the run does
   not abort. ``mptpu`` does the same; the port keeps it
   (``tests/test_torch_siam_train.py`` replays such a run).
7. A catastrophic eval restore clears the pending candidate.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Tuple


class StormGuard:
    """Deterministic storm/rollback bookkeeping.

    The trainer owns the expensive parts (restoring params/opt_state,
    halving lr, clearing handoff tails); the guard owns every *decision*:
    spike classification, hindsight snapshot promotion, and the
    consecutive-rollback abort counter.  States are opaque to the guard
    (tuples of device-array refs — zero copy cost).
    """

    CLEAN = "clean"
    SPIKE = "spike"  # tolerated single spike
    BAD = "bad"      # poisoning -> caller must roll back

    def __init__(
        self,
        grad_clip: float,
        loss_catastrophe: float,
        rel: float = 20.0,
        abs_mult: float = 10.0,
        near_window: int = 12,
        hist_max: int = 40,
        min_hist: int = 10,
        abort_after: int = 12,
        progress_margin: int = 100,
        escalation_growth: float = 3.0,
    ) -> None:
        self.grad_clip = float(grad_clip)
        self.loss_catastrophe = float(loss_catastrophe)
        self.rel = float(rel)
        self.abs_mult = float(abs_mult)
        self.near_window = int(near_window)
        self.hist_max = int(hist_max)
        self.min_hist = int(min_hist)
        self.abort_after = int(abort_after)
        self.progress_margin = int(progress_margin)
        self.escalation_growth = float(escalation_growth)

        self.gnorm_hist: List[float] = []
        self.last_spike_iter = -(10 ** 9)
        self.last_spike_gnorm = 0.0
        self.last_escalation_iter = -(10 ** 9)
        # (state, iter) awaiting a clean hindsight window
        self.snap_candidate: Optional[Tuple[Any, int]] = None
        # (state, iter): the verified rollback target
        self.good: Optional[Tuple[Any, int]] = None
        self.rollbacks = 0        # consecutive failures from one target
        self.total_rollbacks = 0

    # ------------------------------------------------------------------
    def set_initial(self, state: Any, step: int) -> None:
        """Seed the rollback target with the run's starting state."""
        self.good = (state, int(step))

    @staticmethod
    def _median(xs: List[float]) -> float:
        s = sorted(xs)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    # ------------------------------------------------------------------
    def classify(self, ci: int, loss: float, gnorm: float, ok: bool) -> str:
        """Score one (already host-fetched) step's stats.

        Returns CLEAN, SPIKE (tolerated single) or BAD (caller rolls
        back), as ``mptpu``'s guard does on the same stats.
        """
        g = float(gnorm)
        l = float(loss)
        spiked = (
            len(self.gnorm_hist) >= self.min_hist
            and g > self.rel * self._median(self.gnorm_hist)
            and g > self.abs_mult * self.grad_clip
        )
        bad = (not math.isfinite(l)) or l > self.loss_catastrophe or not ok
        verdict = self.CLEAN
        if spiked:
            near_prev = ci - self.last_spike_iter <= self.near_window
            # an escalation needs proximity AND magnitude growth: the
            # sw5/cliff-probe signature grew 186x between paired spikes
            # (7e5 -> 1.3e8), while the sw6 run showed benign CLUSTERED
            # spikes plateauing at ~30x median (144k after 174k) whose
            # rollbacks starved the run to lr_mult 1e-4 — the r3c
            # "rolling back on self-healing spikes kills healthy runs"
            # lesson, repeated one level up.
            growing = g >= self.escalation_growth * self.last_spike_gnorm
            self.last_spike_iter = ci
            self.last_spike_gnorm = g
            if not bad and near_prev and growing:
                # escalating cliff train (sw5: spikes every ~3 checks
                # with clean steps between — a strict consecutive
                # counter never fires)
                self.last_escalation_iter = ci
                bad = True
            elif not bad:
                verdict = self.SPIKE
        if bad:
            return self.BAD
        self.gnorm_hist.append(g)
        if len(self.gnorm_hist) > self.hist_max:
            self.gnorm_hist.pop(0)
        return verdict

    # ------------------------------------------------------------------
    def note_rollback(self) -> bool:
        """Record a rollback to ``good``.  Returns True when the
        consecutive-failure budget is exhausted (caller should abort)."""
        # a candidate from the abandoned trajectory must never be
        # promoted after the restore
        self.snap_candidate = None
        self.gnorm_hist = []
        self.rollbacks += 1
        self.total_rollbacks += 1
        return self.rollbacks >= self.abort_after

    def rollback_target(self) -> Tuple[Any, int]:
        assert self.good is not None, "set_initial() was never called"
        return self.good

    # ------------------------------------------------------------------
    def healthy_boundary(self, i: int, state: Any) -> str:
        """Called at a boundary whose state was VERIFIED healthy by the
        caller (finite forward AND switches clear of the clamp).

        Handles hindsight promotion and candidate capture.  Returns one
        of ``"promoted"``, ``"held"``, ``"discarded"``, optionally
        suffixed with ``"+deferred"`` when the boundary instant was too
        close to a spike for a new candidate capture.
        """
        event = "held"
        cand = self.snap_candidate
        if cand is not None:
            if self.last_escalation_iter < cand[1]:
                # whole window escalation-free: the candidate becomes
                # the rollback target, landing BEHIND any later cliff.
                # Isolated single spikes in the window do not block
                # promotion (they self-heal; ADVICE r4 starvation).
                self.good = cand
                self.rollbacks = 0
                self.snap_candidate = None
                event = "promoted"
            else:
                self.snap_candidate = None
                event = "discarded"
        if self.good is not None and i > self.good[1] + self.progress_margin:
            # verified net progress past the rollback target also proves
            # the cliff was escaped, promotion or not
            self.rollbacks = 0
        if i - self.last_spike_iter > self.near_window:
            self.snap_candidate = (state, i)
        else:
            event += "+deferred"
        return event

    # ------------------------------------------------------------------
    def catastrophic_restore(self, state: Any, step: int) -> None:
        """Eval-catastrophe restore: the trainer jumped back to
        ``best_eval``.  The guard must forget everything learned on the
        abandoned trajectory (ADVICE r4 medium finding)."""
        self.snap_candidate = None
        self.gnorm_hist = []
        self.good = (state, int(step))
