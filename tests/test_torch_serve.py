"""The serve arbiter (``tpuparquet_torch/serve/arbiter.py``) against the
JAX package's (``tpuparquet/serve/arbiter.py``): the same shares,
admissions, rejections, retry-after hints and rebalances on the same
inputs, the thread binding and the budgets that read it, and the
oversubscription guard.  The cases of ``tests/test_serve.py``'s
``TestShares``, ``TestAdmission``, ``TestBinding`` and
``TestOversubscriptionGuard`` run on both packages; random inputs come
from a seeded numpy generator.  Every comparison is exact.

Both arbiters are process-wide: every test leaves them deactivated and
the one-shot warning re-armed (the autouse fixture).
"""

from __future__ import annotations

import os
import threading
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

import tpuparquet.compress as jax_compress
import tpuparquet.deadline as jax_deadline
import tpuparquet.io.writer as jax_writer
import tpuparquet.kernels.device as jax_device
from tpuparquet.obs import attribution as jax_attribution
from tpuparquet.obs import digest as jax_digest
from tpuparquet.obs import live as jax_live
from tpuparquet.serve import arbiter as jax_arbiter
from tpuparquet_torch import compress as port_compress
from tpuparquet_torch import deadline as port_deadline
from tpuparquet_torch.errors import AdmissionRejected, ServeStateError
from tpuparquet_torch.io import writer as port_writer
from tpuparquet_torch.kernels import device as port_device
from tpuparquet_torch.obs import attribution as port_attribution
from tpuparquet_torch.obs import digest as port_digest
from tpuparquet_torch.obs import live as port_live
from tpuparquet_torch.serve import arbiter as port_arbiter

JAX = SimpleNamespace(name="jax", arb=jax_arbiter, attr=jax_attribution,
                      digest=jax_digest, live=jax_live,
                      plan=jax_device._plan_threads,
                      write=jax_writer._write_threads,
                      decode=jax_compress._shared_decode_budget,
                      deadline=jax_deadline,
                      rejected=jax_arbiter.AdmissionRejected)
PORT = SimpleNamespace(name="port", arb=port_arbiter,
                       attr=port_attribution, digest=port_digest,
                       live=port_live, plan=port_device._plan_threads,
                       write=port_writer._write_threads,
                       decode=port_compress._decode_budget,
                       deadline=port_deadline, rejected=AdmissionRejected)
SIDES = (JAX, PORT)


@pytest.fixture(autouse=True)
def _no_arbiter_left():
    yield
    for side in SIDES:
        a = side.arb.active()
        if a is not None:
            side.arb.deactivate(a)
        side.arb._reset_oversub_warning()


@pytest.fixture()
def telemetry():
    """Fresh ledgers and digests in both packages, restored after."""
    saved = [side.digest.digests() for side in SIDES]
    for side in SIDES:
        side.attr.reset_ledgers()
        side.digest.set_digests(True)
    yield
    for side, reg in zip(SIDES, saved):
        side.attr.reset_ledgers()
        side.digest._active = reg


def _both(fn):
    """``fn(side)`` on each package; asserts the two results are equal
    and returns the port's."""
    got = [fn(side) for side in SIDES]
    assert got[1] == got[0]
    return got[1]


# ----------------------------------------------------------------------
# shares
# ----------------------------------------------------------------------

class TestShares:
    def test_equal_weights_split_evenly(self):
        def run(side):
            arb = side.arb.ResourceArbiter(total_workers=8)
            for i in range(4):
                arb.register(f"t{i}")
            return arb.shares()
        assert _both(run) == {f"t{i}": 2 for i in range(4)}

    def test_weighted_shares_sum_to_budget(self):
        def run(side):
            arb = side.arb.ResourceArbiter(total_workers=10)
            arb.register("heavy", weight=3.0)
            arb.register("light", weight=1.0)
            return arb.shares()
        s = _both(run)
        assert sum(s.values()) == 10 and s["heavy"] > s["light"] >= 1

    def test_floor_when_workers_scarce(self):
        def run(side):
            arb = side.arb.ResourceArbiter(total_workers=2)
            for i in range(5):
                arb.register(f"t{i}")
            return arb.shares()
        assert _both(run) == {f"t{i}": 1 for i in range(5)}

    def test_greedy_tenant_cannot_starve_others(self):
        def run(side):
            arb = side.arb.ResourceArbiter(total_workers=8)
            arb.register("greedy", weight=10_000.0)
            for i in range(3):
                arb.register(f"meek{i}", weight=1.0)
            return arb.shares()
        s = _both(run)
        assert sum(s.values()) == 8
        assert min(s[f"meek{i}"] for i in range(3)) >= 1

    def test_unregister_recomputes(self):
        def run(side):
            arb = side.arb.ResourceArbiter(total_workers=4)
            arb.register("a")
            arb.register("b")
            arb.unregister("b")
            return arb.shares(), arb.tenants()
        assert _both(run) == ({"a": 4}, ["a"])

    def test_adaptive_boosts_are_bounded(self):
        def run(side):
            arb = side.arb.ResourceArbiter(total_workers=8)
            arb.register("hot", latency_target_ms=1.0)
            arb.register("cold")
            with arb._lock:
                t = arb._tenants["hot"]
                t.last_burn = 1e12
                t.last_bound = "plan-bound"
                t.last_p99_ms = 1e9
                arb._recompute_locked()
            return arb.shares()
        s = _both(run)
        assert sum(s.values()) == 8 and s["hot"] > s["cold"] >= 1

    @pytest.mark.parametrize("seed", range(6))
    def test_random_registrations_as_reference(self, seed):
        """Random budgets, weights, re-weights and removals: the same
        share map after every step, and the same tenant states."""
        rng = np.random.default_rng(seed)
        total = int(rng.integers(1, 40))
        steps = []
        for _ in range(30):
            label = f"t{int(rng.integers(0, 8))}"
            if rng.random() < 0.2:
                steps.append(("unregister", label, None))
            else:
                steps.append(("register", label,
                              float(rng.choice([0.0, 0.5, 1.0, 2.0, 7.0,
                                                1e4]))))

        def run(side):
            arb = side.arb.ResourceArbiter(total_workers=total)
            trail = []
            for op, label, w in steps:
                if op == "register":
                    arb.register(label, weight=w)
                else:
                    arb.unregister(label)
                trail.append((arb.shares(), arb.share_of(label)))
            return trail, arb.tenants_state()
        _both(run)

    def test_budget_from_the_environment(self, monkeypatch):
        monkeypatch.setenv("TPQ_SERVE_WORKERS", "5")
        monkeypatch.setenv("TPQ_SERVE_QUEUE", "3")
        assert _both(lambda side: (
            side.arb.serve_workers(), side.arb.queue_bound_default(),
            side.arb.ResourceArbiter().total_workers)) == (5, 3, 5)
        monkeypatch.setenv("TPQ_SERVE_WORKERS", "bogus")
        assert _both(lambda side: side.arb.serve_workers()) == \
            len(os.sched_getaffinity(0))
        for side in SIDES:
            with pytest.raises(ValueError, match="total_workers"):
                side.arb.ResourceArbiter(total_workers=0)


# ----------------------------------------------------------------------
# admission control
# ----------------------------------------------------------------------

def _admit(arb, label, rejected, **kw):
    """``None`` when admitted, else the rejection's fields."""
    try:
        arb.admit(label, **kw)
        return None
    except rejected as e:
        return (str(e), e.tenant, e.reason, e.retry_after_s)


class TestAdmission:
    def test_unknown_tenant_is_an_error(self):
        for side in SIDES:
            with pytest.raises(KeyError, match="ghost"):
                side.arb.ResourceArbiter(total_workers=2).admit("ghost")

    def test_queue_full_sheds_load(self):
        def run(side):
            arb = side.arb.ResourceArbiter(total_workers=2)
            arb.register("t")
            return _admit(arb, "t", side.rejected, queue_depth=3,
                          queue_bound=3)
        msg, tenant, reason, retry = _both(run)
        assert (tenant, reason) == ("t", "queue_full") and retry > 0
        assert "queue is full (3/3)" in msg

    def test_byte_budget_exhaustion(self):
        def run(side):
            arb = side.arb.ResourceArbiter(total_workers=2)
            arb.register("t", byte_budget=100)
            out = [_admit(arb, "t", side.rejected, est_bytes=60),
                   _admit(arb, "t", side.rejected, est_bytes=60)]
            arb.retract("t", 60)
            out.append(_admit(arb, "t", side.rejected, est_bytes=60))
            return out, arb.tenants_state()
        out, state = _both(run)
        assert out[0] is None and out[1][2] == "byte_budget"
        assert out[2] is None

    def test_deadline_budget_sheds_doomed_jobs(self):
        def run(side):
            arb = side.arb.ResourceArbiter(total_workers=2)
            arb.register("t")
            out = [_admit(arb, "t", side.rejected, deadline_s=0.001)]
            arb.note_job_done("t", 10.0)
            out.append(_admit(arb, "t", side.rejected, deadline_s=5.0,
                              queue_depth=2, queue_bound=8))
            out.append(_admit(arb, "t", side.rejected, deadline_s=100.0,
                              queue_depth=2, queue_bound=8))
            return out
        out = _both(run)
        assert out[0] is None and out[1][2] == "deadline_budget"
        assert out[1][3] == 10.0 and out[2] is None

    def test_release_refunds_inflight_bytes(self):
        def run(side):
            arb = side.arb.ResourceArbiter(total_workers=2)
            arb.register("t", byte_budget=100)
            out = [_admit(arb, "t", side.rejected, est_bytes=60),
                   _admit(arb, "t", side.rejected, est_bytes=60)]
            arb.release("t", 60)
            out.append(_admit(arb, "t", side.rejected, est_bytes=60))
            out.append(dict(arb.tenants_state()["t"]))
            arb.release("t", 10**9)
            arb.release("ghost", 5)
            out.append(dict(arb.tenants_state()["t"]))
            return out
        out = _both(run)
        assert (out[3]["admitted"], out[3]["rejected"],
                out[3]["bytes_admitted"]) == (2, 1, 60)
        assert out[4]["bytes_admitted"] == 0

    @pytest.mark.parametrize("seed", range(6))
    def test_random_admissions_as_reference(self, seed):
        """A random stream of admissions, retractions, releases and
        finished jobs over three tenants: every outcome (admitted, or the
        rejection's words, reason and retry-after) and the final states
        equal the reference's."""
        rng = np.random.default_rng(100 + seed)
        ops = []
        for _ in range(80):
            label = f"t{int(rng.integers(0, 3))}"
            r = rng.random()
            if r < 0.55:
                ops.append(("admit", label, dict(
                    est_bytes=int(rng.integers(0, 400)),
                    deadline_s=(None if rng.random() < 0.5
                                else float(rng.integers(1, 60))),
                    queue_depth=int(rng.integers(0, 10)),
                    queue_bound=(None if rng.random() < 0.5
                                 else int(rng.integers(1, 10))))))
            elif r < 0.7:
                ops.append(("retract", label, int(rng.integers(0, 400))))
            elif r < 0.85:
                ops.append(("release", label, int(rng.integers(0, 400))))
            else:
                ops.append(("done", label, float(rng.random() * 20),
                            bool(rng.random() < 0.8)))

        def run(side):
            arb = side.arb.ResourceArbiter(total_workers=6)
            for i, budget in enumerate((None, 500, 1000)):
                arb.register(f"t{i}", weight=i + 1.0, byte_budget=budget)
            out = []
            for op in ops:
                if op[0] == "admit":
                    out.append(_admit(arb, op[1], side.rejected, **op[2]))
                elif op[0] == "retract":
                    arb.retract(op[1], op[2])
                elif op[0] == "release":
                    arb.release(op[1], op[2])
                else:
                    arb.note_job_done(op[1], op[2], ok=op[3])
            return out, arb.tenants_state()
        _both(run)


# ----------------------------------------------------------------------
# rebalance from the ledgers, digests and SLO burn rates
# ----------------------------------------------------------------------

def _feed(side, rng_seed: int, rounds: int):
    """Feed the same ledgers and unit digests to ``side`` and rebalance
    after each round; returns every round's shares and states."""
    rng = np.random.default_rng(rng_seed)
    arb = side.arb.ResourceArbiter(total_workers=12)
    arb.register("fast", weight=1.0, latency_target_ms=50.0,
                 error_rate_target=0.01)
    arb.register("slow", weight=1.0, latency_target_ms=20.0)
    arb.register("idle", weight=2.0, error_rate_target=0.05)
    out = []
    for _ in range(rounds):
        for label in ("fast", "slow"):
            led = side.attr.ledger(label)
            led.fold_delta({
                "plan_s": float(rng.random()),
                "read_s": float(rng.random() * 0.5),
                "transfer_s": float(rng.random() * 0.2),
                "row_groups": int(rng.integers(1, 50)),
                "units_quarantined": int(rng.integers(0, 3)),
                "io_retries": int(rng.integers(0, 2))})
            for v in rng.integers(1_000, 200_000, 20):
                side.digest.observe(label, "unit", int(v))
        out.append((arb.rebalance(), arb.tenants_state()))
    return out


class TestRebalance:
    @pytest.mark.parametrize("seed", range(4))
    def test_rebalance_as_reference(self, telemetry, seed):
        """Equal ledgers (bound verdicts, windowed error burn) and equal
        digests (unit p99) give equal shares and tenant states, round
        after round."""
        got = [_feed(side, seed, 4) for side in SIDES]
        assert got[1] == got[0]
        # the feedback moved something
        states = got[1][-1][1]
        assert states["fast"]["bound"] is not None
        assert states["slow"]["p99_ms"] is not None

    def test_rebalance_without_telemetry_is_static(self):
        saved = [side.digest.digests() for side in SIDES]
        try:
            def run(side):
                side.attr.reset_ledgers()
                side.digest.set_digests(False)
                arb = side.arb.ResourceArbiter(total_workers=7)
                arb.register("a", weight=1.0)
                arb.register("b", weight=2.0)
                before = arb.shares()
                return before, arb.rebalance(), \
                    side.arb.ResourceArbiter(total_workers=3).rebalance()
            before, after, empty = _both(run)
            assert before == after and empty == {}
        finally:
            for side, reg in zip(SIDES, saved):
                side.digest._active = reg


# ----------------------------------------------------------------------
# activation, the thread binding and the budgets that read it
# ----------------------------------------------------------------------

def _legacy_budgets(monkeypatch, plan, write):
    for k, v in (("TPQ_PLAN_THREADS", plan), ("TPQ_WRITE_THREADS", write)):
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)


class TestBinding:
    def test_plan_budget_reads_the_bound_tenants_share(self):
        def run(side):
            a = side.arb
            out = [a.plan_budget(), a.current_binding()]
            arb = a.ResourceArbiter(total_workers=6)
            arb.register("a", weight=2.0)
            arb.register("b", weight=1.0)
            a.activate(arb)
            try:
                out.append((a.active() is arb, a.plan_budget()))
                with a.tenant_scope("a"):
                    out.append((a.current_binding(), a.plan_budget(),
                                a.write_budget()))
                    with a.tenant_scope("b"):
                        out.append((a.current_binding(), a.plan_budget()))
                    with a.tenant_scope("ghost"):
                        out.append(a.plan_budget())
                    with a.tenant_scope(None):
                        out.append(a.plan_budget())
                    out.append(a.plan_budget())
                out.append(a.plan_budget())
            finally:
                a.deactivate(arb)
            out.append((a.active(), a.plan_budget()))
            return out
        out = _both(run)
        assert out[3] == ("a", 4, 4) and out[4] == ("b", 2)

    @pytest.mark.parametrize("plan,write", [(None, None), ("3", None),
                                            (None, "2"), ("bogus", "0")])
    def test_budgets_without_an_arbiter(self, monkeypatch, plan, write):
        """No arbiter active: every budget is the legacy knob's, as in
        the reference (and as before the arbiter existed)."""
        _legacy_budgets(monkeypatch, plan, write)
        cpus = len(os.sched_getaffinity(0))
        got = _both(lambda side: (side.plan(), side.write(),
                                  side.decode()))
        want_plan = int(plan) if plan and plan.isdigit() else cpus
        want_write = max(int(write), 1) if write and write.isdigit() \
            else cpus
        assert got == (max(want_plan, 1), want_write, cpus)

    def test_budgets_bounded_by_shares_not_cores(self, monkeypatch):
        _legacy_budgets(monkeypatch, "64", "64")

        def run(side):
            a = side.arb
            arb = a.ResourceArbiter(total_workers=4)
            labels = [f"t{i}" for i in range(4)]
            for lb in labels:
                arb.register(lb)
            a.activate(arb)
            out = []
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)
                    for lb in labels:
                        with a.tenant_scope(lb):
                            out.append((side.plan(), side.write(),
                                        side.decode()))
                    out.append(side.plan())  # unbound: the knob
            finally:
                a.deactivate(arb)
            return out
        out = _both(run)
        assert out[:4] == [(1, 1, 1)] * 4 and out[4] == 64

    def test_second_arbiter_cannot_activate(self):
        for side in SIDES:
            a = side.arb.ResourceArbiter(total_workers=1)
            b = side.arb.ResourceArbiter(total_workers=1)
            side.arb.activate(a)
            try:
                with pytest.raises(RuntimeError, match="already active"):
                    side.arb.activate(b)
                side.arb.activate(a)  # the same instance: no error
                side.arb.deactivate(b)  # not the active one: no change
                assert side.arb.active() is a
            finally:
                side.arb.deactivate(a)
        with pytest.raises(ServeStateError):
            a = port_arbiter.ResourceArbiter(total_workers=1)
            port_arbiter.activate(a)
            port_arbiter.activate(port_arbiter.ResourceArbiter(1))

    def test_binding_rides_into_deadline_and_hedge_workers(self):
        """``call_with_deadline`` and ``hedged_call`` run their callables
        on worker threads under the caller's tenant binding; the budget
        read there is the tenant's share."""
        def run(side):
            a = side.arb
            arb = a.ResourceArbiter(total_workers=5)
            arb.register("x", weight=1.0)
            arb.register("y", weight=4.0)
            a.activate(arb)
            seen = []

            def probe():
                seen.append((threading.current_thread() is not
                             threading.main_thread(), a.current_binding(),
                             a.plan_budget(), side.plan()))
                return len(seen)

            try:
                with a.tenant_scope("y"):
                    side.deadline.call_with_deadline(probe, 10.0,
                                                     site="t.deadline")
                    side.deadline.hedged_call([probe], delay=10.0,
                                              site="t.hedge", budget=10.0)
                side.deadline.call_with_deadline(probe, 10.0,
                                                 site="t.deadline")
            finally:
                a.deactivate(arb)
            return seen
        seen = _both(run)
        assert seen[0] == seen[1] == (True, "y", 3, 3)
        assert seen[2][:3] == (True, None, None)


# ----------------------------------------------------------------------
# the oversubscription guard
# ----------------------------------------------------------------------

class TestOversubscriptionGuard:
    def test_warns_once_and_publishes_the_gauge(self, monkeypatch):
        cores = len(os.sched_getaffinity(0))
        _legacy_budgets(monkeypatch, str(cores + 3), str(cores))
        for side in SIDES:
            side.arb._reset_oversub_warning()
            side.live.reset_registry()
            try:
                with pytest.warns(RuntimeWarning, match="exceeds"):
                    excess = side.arb.warn_if_oversubscribed()
                assert excess == cores + 3
                gauges = side.live.registry().snapshot()["gauges"]
                assert gauges["threads_oversubscribed"] == float(excess)
                with warnings.catch_warnings():
                    warnings.simplefilter("error")
                    assert side.arb.warn_if_oversubscribed() == excess
            finally:
                side.arb._reset_oversub_warning()
                side.live.reset_registry()

    def test_the_budget_readers_warn(self, monkeypatch):
        """``_plan_threads`` and ``_write_threads`` run the guard when no
        arbiter sizes them, in both packages."""
        cores = len(os.sched_getaffinity(0))
        _legacy_budgets(monkeypatch, str(cores), "1")
        for side in SIDES:
            for fn in (side.plan, side.write):
                side.arb._reset_oversub_warning()
                with pytest.warns(RuntimeWarning, match="exceeds"):
                    fn()

    @pytest.mark.parametrize("plan,write", [(None, None), ("1", None),
                                            ("1", "bogus"), ("1", "1")])
    def test_silent_when_within_budget_or_unset(self, monkeypatch, plan,
                                                write):
        _legacy_budgets(monkeypatch, plan, write)
        cores = len(os.sched_getaffinity(0))
        want = max(2 - cores, 0) if (plan, write) == ("1", "1") else 0

        def run(side):
            side.arb._reset_oversub_warning()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                return side.arb.warn_if_oversubscribed()
        assert _both(run) == want
