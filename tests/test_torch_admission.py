"""Port parity for multi-tenant admission: ``TokenBucket``,
``ElasticController`` and ``TenantScheduler``.

Each case is a script that drives one package's admission objects with
synthetic items (no solver in the loop) and records, at every step, what
the call returned and the whole accounting state: queues, deficits,
reserves, counters, bucket tokens, the forecast.  The port's transcript
must equal the reference's exactly.  The invariants the reference's own
tests pin — slot conservation, per-tenant FIFO, no starvation, overdue
promotion charging the deficit, DRR shares, bucket conservation, the
elastic controller's monotonicity — are then asserted on the port's
objects.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.queryengine import workloads as ref_wl
from repro.serve import admission as ref_adm
from repro_torch.queryengine import workloads as port_wl
from repro_torch.serve import admission as port_adm

REF = types.SimpleNamespace(wl=ref_wl, adm=ref_adm)
PORT = types.SimpleNamespace(wl=port_wl, adm=port_adm)


def _state(sched):
    return [(s.name, s.weights, s.share, s.priority, s.budget_s, s.slo,
             s.reserve_q_s, s.deficit, list(s.queue), s.n_enqueued,
             s.n_dequeued, s.n_shed, s.n_degraded, s.n_rate_limited,
             s.slots_granted,
             None if s.bucket is None else (s.bucket.tokens,
                                            s.bucket.clock_s))
            for s in sched.states()] + [sched.default_reserve_q_s]


def _both(script, *args):
    """Run ``script`` on both packages; the transcripts must be equal.
    Returns the port's transcript and objects."""
    ref = script(REF, *args)
    got = script(PORT, *args)
    assert got[0] == ref[0]
    return got


def _random_specs(m, rng, n_tenants, slo=False, limit=False):
    out = []
    for i in range(n_tenants):
        kw = dict(share=float(rng.choice([0.5, 1.0, 2.0, 3.0])),
                  priority=int(rng.integers(0, 3)),
                  solve_budget_s=float(rng.choice([0.5, 1.0, 2.0])))
        if slo:
            kw["slo"] = str(rng.choice(m.wl.SLO_CLASSES))
        if limit and rng.random() < 0.5:
            kw.update(rate_limit_qps=float(rng.choice([2.0, 8.0])),
                      rate_limit_burst=float(rng.choice([1.0, 3.0])))
        out.append(m.wl.TenantSpec(name=f"t{i}", **kw))
    return out


# ---------------------------------------------------------------------------
# Randomized call sequences: every decision and all state, step by step
# ---------------------------------------------------------------------------

def _scheduler_script(m, seed):
    """A random interleaving of door admissions, sheds, composes (with and
    without a degrade lead), solve notes and deadline queries."""
    rng = np.random.default_rng(seed)
    n_tenants = int(rng.integers(1, 5))
    specs = _random_specs(m, rng, n_tenants, slo=True, limit=True)
    sched = m.adm.TenantScheduler(specs, budget_s=float(rng.choice([0.5,
                                                                    1.0])),
                                  reserve_q_s=0.1, reserve_ewma=0.3)
    out, grants, order = [], [], {}
    t, k = 0.0, 0
    for _ in range(80):
        op = rng.random()
        if op < 0.5:
            t += float(rng.exponential(0.05))
            name = specs[int(rng.integers(0, n_tenants))].name
            if rng.random() < 0.1:
                name = "walk-in"
            item = (name, k)
            k += 1
            ok = sched.admit_arrival(name, item, t)
            out.append(("arrive", ok))
            if ok:
                order.setdefault(name, []).append(item)
        elif op < 0.6:
            cap = int(rng.integers(1, 9))
            out.append(("shed", sched.shed_unmeetable(t, cap)))
        elif op < 0.85:
            cap = int(rng.integers(1, 9))
            lead = float(rng.choice([0.0, 0.0, 0.3]))
            before = {s.name: s.slots_granted for s in sched.states()}
            picked = sched.compose(t, cap, lead)
            out.append(("compose", [tuple(a) for a in picked]))
            assert len(picked) <= cap
            granted = sum(s.slots_granted - before.get(s.name, 0)
                          for s in sched.states())
            assert granted == len(picked)                # conservation
            grants.extend(picked)
            for s in sched.states():
                assert s.deficit >= 0.0                  # charge floored
                if not s.queue:
                    assert s.deficit == 0.0              # standard reset
        elif op < 0.95:
            n = int(rng.integers(1, 9))
            dt = float(rng.exponential(0.05 * n))
            names = [str(rng.choice([s.name for s in specs] + ["new"]))
                     for _ in range(n)]
            sched.note_solve(dt, n, names)
            out.append(("note", dt))
        else:
            cap = int(rng.integers(1, 9))
            out.append(("deadline", sched.next_deadline(cap),
                        sched.deadline_due(t, cap), sched.total_waiting()))
        out.append(_state(sched))
    return out, sched, grants, order


@pytest.mark.parametrize("seed", range(10))
def test_scheduler_call_sequence_equal(seed):
    _, sched, grants, order = _both(_scheduler_script, seed)
    # Per-tenant FIFO over everything composed or shed.
    popped = {}
    for a in grants:
        popped.setdefault(a.tenant, []).append(a.item)
    for name, items in popped.items():
        assert items == [i for i in order[name] if i in items]


def _bucket_script(m, seed):
    rng = np.random.default_rng(seed)
    rate = float(rng.uniform(0.5, 8.0))
    burst = float(rng.integers(1, 6))
    b = m.adm.TokenBucket(rate_qps=rate, burst=burst)
    out, t, admitted = [], 0.0, 0
    for _ in range(60):
        # Mostly forward in time, now and then a step back (replays must
        # not mint tokens).
        t += float(rng.exponential(0.3)) if rng.random() < 0.9 \
            else -float(rng.uniform(0.0, 1.0))
        ok = b.take(t)
        admitted += ok
        out.append((ok, b.tokens, b.clock_s))
    return out, b, rate, burst


@pytest.mark.parametrize("seed", range(6))
def test_token_bucket_sequence_equal(seed):
    out, b, rate, burst = _both(_bucket_script, seed)
    clock = max(c for _, _, c in out)
    assert sum(ok for ok, _, _ in out) <= burst + clock * rate + 1e-9
    assert all(0.0 <= tok <= burst for _, tok, _ in out)
    # One refill interval after the last refill always buys a token.
    assert b.take(b.clock_s + 1.0 / rate + 1e-9)


def _elastic_script(m, seed):
    rng = np.random.default_rng(seed)
    pol = m.adm.ElasticPolicy(min_batch=int(rng.integers(1, 4)),
                              max_batch=int(rng.integers(4, 33)),
                              target_delay_s=float(rng.uniform(0.05, 2.0)),
                              ewma=float(rng.uniform(0.05, 1.0)),
                              degrade_frac=float(rng.uniform(0.0, 1.0)))
    ctl = m.adm.ElasticController(pol)
    out = []
    for d in rng.uniform(-0.5, 3.0, size=12):
        ctl.note_flush(float(d))
        row = [ctl.forecast_s, ctl.n_windows]
        for base in (1, 4, 8, 40):
            row += [ctl.batch_cap(base),
                    ctl.flush_budget_s(0.05, base),
                    ctl.headroom_s(1.0, 0.05, base),
                    ctl.degrade_lead_s(1.0, 0.05, base)]
        out.append(row)
    return out, pol


@pytest.mark.parametrize("seed", range(6))
def test_elastic_controller_sequence_equal(seed):
    _, pol = _both(_elastic_script, seed)
    # Monotone in the forecast: more pressure never lowers the cap, never
    # raises the headroom, never shortens the degrade lead.
    caps, heads, leads = [], [], []
    for f in np.linspace(0.0, 5.0 * pol.target_delay_s, 12):
        c = port_adm.ElasticController(pol)
        c.forecast_s = float(f)
        caps.append(c.batch_cap(4))
        heads.append(c.headroom_s(1.0, 0.05, 4))
        leads.append(c.degrade_lead_s(1.0, 0.05, 4))
    assert all(b >= a for a, b in zip(caps, caps[1:]))
    assert all(b <= a + 1e-12 for a, b in zip(heads, heads[1:]))
    assert all(b >= a - 1e-12 for a, b in zip(leads, leads[1:]))
    assert all(0.0 <= x <= 1.0 for x in leads)


# ---------------------------------------------------------------------------
# The reference's fixed cases, each as a transcript held to the reference
# ---------------------------------------------------------------------------

def _no_starvation(m, cap):
    low = m.wl.TenantSpec(name="low", priority=0, share=0.5,
                          solve_budget_s=1.0)
    high = m.wl.TenantSpec(name="high", priority=3, share=3.0,
                           solve_budget_s=10.0)
    sched = m.adm.TenantScheduler([low, high], reserve_q_s=0.0)
    sched.enqueue("low", "starved", 0.0)
    for k in range(50):
        sched.enqueue("high", f"h{k}", 0.0)
    before = sched.compose(0.5, cap)
    after = sched.compose(1.0, cap)
    return ([tuple(a) for a in before], [tuple(a) for a in after],
            _state(sched)), before, after


@pytest.mark.parametrize("cap", [1, 3, 6])
def test_no_starvation_overdue_beats_priority(cap):
    _, before, after = _both(_no_starvation, cap)
    assert all(a.tenant == "high" for a in before)
    assert tuple(after[0]) == ("low", "starved", False)


def _overdue_charge(m):
    sched = m.adm.TenantScheduler(
        [m.wl.TenantSpec(name="a", solve_budget_s=1.0),
         m.wl.TenantSpec(name="b", solve_budget_s=1e9)], reserve_q_s=0.0)
    for k in range(4):
        sched.enqueue("a", f"a{k}", 0.0)
        sched.enqueue("b", f"b{k}", 100.0)
    sched.state("a").deficit = 1.0
    first = sched.compose(2.0, cap=2)
    d1 = sched.state("a").deficit
    sched.state("a").deficit = 0.25
    second = sched.compose(2.0, cap=1)
    d2 = sched.state("a").deficit
    return ([tuple(x) for x in first + second], d1, d2,
            _state(sched)), first, second


def test_overdue_pop_charges_banked_credit():
    (_, d1, d2, _), first, second = _both(_overdue_charge)
    assert first[0].tenant == "a" and d1 == 0.0
    assert second[0].tenant == "a" and d2 == 0.0


def _drr(m, share_a, share_b):
    sched = m.adm.TenantScheduler(
        [m.wl.TenantSpec(name="a", share=float(share_a), solve_budget_s=1e9),
         m.wl.TenantSpec(name="b", share=float(share_b), solve_budget_s=1e9)],
        reserve_q_s=0.0)
    n = 50 * (share_a + share_b)
    for k in range(n):
        sched.enqueue("a", k, 0.0)
        sched.enqueue("b", k, 0.0)
    grants = []
    while len(grants) < n:
        grants.extend(a.tenant for a in sched.compose(0.0, 8))
    return (grants, _state(sched)), n


@pytest.mark.parametrize("share_a,share_b", [(1, 1), (1, 3), (4, 2)])
def test_drr_shares_track_ratio(share_a, share_b):
    (grants, _), n = _both(_drr, share_a, share_b)
    want = n * share_a / (share_a + share_b)
    assert abs(grants[:n].count("a") - want) <= 8 + share_a + share_b


def _triage(m):
    sched = m.adm.TenantScheduler(
        [m.wl.TenantSpec(name="s", slo="strict", solve_budget_s=0.1),
         m.wl.TenantSpec(name="d", slo="degrade", solve_budget_s=0.1),
         m.wl.TenantSpec(name="b", slo="best_effort", solve_budget_s=0.1),
         m.wl.TenantSpec(name="s2", slo="strict", solve_budget_s=0.8)],
        reserve_q_s=0.25)
    for name in ("s", "d", "b"):
        sched.enqueue(name, f"{name}0", 0.0)
        sched.enqueue(name, f"{name}1", 0.0)
    for k in range(4):
        sched.enqueue("s2", k, 9.95)
    shed = sched.shed_unmeetable(10.0, cap=8)
    picked = sched.compose(10.0, cap=8)
    sched.enqueue("d", "late", 20.0)
    late = sched.compose(20.0, cap=8)
    return (shed, [tuple(a) for a in picked], [tuple(a) for a in late],
            _state(sched)), sched


def test_shed_and_degrade_triage():
    (shed, picked, late, _), sched = _both(_triage)
    # Strict heads shed while even the shrinking pool cannot meet them.
    assert [n for n, _ in shed].count("s") == 2
    assert ("d", "d0", True) in picked and ("b", "b0", False) in picked
    # A budget below one query's reserve is unmeetable even when fresh.
    assert late == [("d", "late", True)]
    assert sched.state("s").slots_granted == 0


def _reserve(m):
    sched = m.adm.TenantScheduler([], budget_s=1.0, reserve_q_s=0.25,
                                  reserve_ewma=0.3)
    sched.note_solve(8.0, 8, ["a"])
    sched.enqueue("a", "x", arrival_s=10.0)
    d1 = sched.next_deadline(cap=8)
    for k in range(3):
        sched.enqueue("a", k, arrival_s=10.0)
    d4 = sched.next_deadline(cap=8)
    return (d1, d4, sched.state("b").reserve_q_s, _state(sched)), sched


def test_reserve_normalized_per_query():
    (d1, d4, fresh, _), sched = _both(_reserve)
    r = sched.state("a").reserve_q_s
    assert r == pytest.approx(0.7 * 0.25 + 0.3 * 1.0)
    assert d1 == pytest.approx(11.0 - r) and d4 == pytest.approx(11.0 - 4 * r)
    assert fresh == sched.default_reserve_q_s


def _tiny_share(m):
    sched = m.adm.TenantScheduler(
        [m.wl.TenantSpec(name="tiny", share=1e-9, solve_budget_s=1e9),
         m.wl.TenantSpec(name="big", share=1.0, solve_budget_s=1e9)],
        reserve_q_s=0.0)
    for k in range(20):
        sched.enqueue("tiny", k, 0.0)
        sched.enqueue("big", k, 0.0)
    return ([a.tenant for a in sched.compose(0.0, 8)],), None


def test_tiny_share_composes_in_bounded_passes():
    (grants,), _ = _both(_tiny_share)
    assert grants.count("big") >= 7


BAD = {
    "bucket_rate": lambda m: m.adm.TokenBucket(rate_qps=0.0, burst=1.0),
    "bucket_burst": lambda m: m.adm.TokenBucket(rate_qps=1.0, burst=0.0),
    "min_batch": lambda m: m.adm.ElasticPolicy(min_batch=4, max_batch=2),
    "target": lambda m: m.adm.ElasticPolicy(target_delay_s=0.0),
    "ewma": lambda m: m.adm.ElasticPolicy(ewma=0.0),
    "degrade_frac": lambda m: m.adm.ElasticPolicy(degrade_frac=1.5),
    "duplicate": lambda m: m.adm.TenantScheduler(
        [m.wl.TenantSpec(name="a"), m.wl.TenantSpec(name="a")]),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_admission_validation_equal(case):
    with pytest.raises(ValueError) as a:
        BAD[case](REF)
    with pytest.raises(ValueError) as b:
        BAD[case](PORT)
    assert str(a.value) == str(b.value)


def test_walk_in_tenant_defaults_equal():
    def script(m):
        sched = m.adm.TenantScheduler([], budget_s=2.0, reserve_q_s=0.125)
        sched.enqueue("walk-in", "x", 1.0)
        return ([tuple(a) for a in sched.compose(100.0, 4)],
                _state(sched)), sched
    (picked, _), sched = _both(script)
    assert picked == [("walk-in", "x", False)]
    st = sched.state("walk-in")
    assert (st.budget_s, st.reserve_q_s, st.slo) == (2.0, 0.125,
                                                      "best_effort")
