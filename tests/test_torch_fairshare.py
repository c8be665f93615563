"""The port's admission policies (``repro_torch.serving.fairshare``,
DESIGN.md §15) against the JAX package's: the tests of
``tests/test_fairshare.py`` (WFQ ordering, SRPT bias, aging, budgets,
deterministic shedding), each run on the port, and each decision sequence
also equal to ``repro.serving.fairshare``'s on the same ``FakeReq``
script.

Each script is written once against a :class:`Side` (one package's
policy classes and config), so both packages run the same code.  Pure
control plane: no model, no tensors.
"""
import dataclasses
from typing import Any

import pytest

from repro.core.config import ServeConfig as JServeConfig
from repro.serving import fairshare as jfairshare
from repro_torch.core.config import ServeConfig as TServeConfig
from repro_torch.serving import fairshare as tfairshare


@dataclasses.dataclass
class FakeReq:
    rid: int
    tenant: str = "default"
    prompt: tuple = tuple(range(32))
    max_new_tokens: int = 8
    arrival: float = 0.0


@dataclasses.dataclass
class Side:
    """One package's admission module and its ``ServeConfig``."""
    fs: Any
    ServeConfig: Any

    def sc(self, **kw):
        return self.ServeConfig(page_size=16, max_pages=64, max_batch=4,
                                **kw)

    def policy(self, **kw):
        return self.fs.make_policy(self.sc(**kw))


PORT = Side(tfairshare, TServeConfig)
REF = Side(jfairshare, JServeConfig)


def both(script):
    """``script`` run on the port and on the reference: the port's result,
    after checking that the reference's is the same."""
    got, want = script(PORT), script(REF)
    assert got == want, (got, want)
    return got


def rid(req):
    return None if req is None else req.rid


def victims(pol, waiting, now):
    return [(r.rid, ra) for r, ra in pol.shed(waiting, now=now)]


# ----------------------------------------------------------------- scripts
def dispatch(side):
    out = [type(side.policy()).__name__,
           type(side.policy(admission="fairshare")).__name__]
    with pytest.raises(ValueError):
        side.policy(admission="lottery")
    return out


def fifo_order(side):
    waiting = [FakeReq(rid=1, arrival=0.0), FakeReq(rid=2, arrival=1.0)]
    return rid(side.policy().select(waiting, now=2.0))


def over_budget(admission):
    def script(side):
        pol = side.policy(admission=admission, tenant_max_concurrent=1)
        pol.tenant("hog").concurrent = 1
        waiting = [FakeReq(rid=1, tenant="hog"),
                   FakeReq(rid=2, tenant="light")]
        return rid(pol.select(waiting, now=0.0))
    return script


def underserved(side):
    pol = side.policy(admission="fairshare")
    pol.tenant("hog").service = 10_000.0
    waiting = [FakeReq(rid=1, tenant="hog", arrival=0.0),
               FakeReq(rid=2, tenant="light", arrival=5.0)]
    return rid(pol.select(waiting, now=5.0))


def weights(side):
    pol = side.policy(admission="fairshare",
                      tenant_weights=(("premium", 4.0),))
    pol.tenant("premium").service = 400.0
    pol.tenant("basic").service = 200.0
    waiting = [FakeReq(rid=1, tenant="basic"),
               FakeReq(rid=2, tenant="premium")]
    return rid(pol.select(waiting, now=0.0)), pol.snapshot()


def srpt(side):
    pol = side.policy(admission="fairshare", fair_aging_tokens_per_s=0)
    waiting = [FakeReq(rid=1, prompt=tuple(range(100)), max_new_tokens=64),
               FakeReq(rid=2, prompt=tuple(range(8)), max_new_tokens=4)]
    return rid(pol.select(waiting, now=0.0)), \
        [pol.score(r, 0.0) for r in waiting]


def prefix_hit(side):
    pol = side.fs.FairShareAdmission(
        side.sc(admission="fairshare"),
        probe_hit=lambda r: 1.0 if r.rid == 2 else 0.0)
    waiting = [FakeReq(rid=1), FakeReq(rid=2)]
    return [pol.cost(r) for r in waiting], rid(pol.select(waiting, now=0.0))


def aging(side):
    pol = side.policy(admission="fairshare", fair_srpt_weight=1.0,
                      fair_aging_tokens_per_s=50.0)
    old_big = FakeReq(rid=1, prompt=tuple(range(500)), max_new_tokens=100,
                      arrival=0.0)
    return [rid(pol.select([old_big, FakeReq(rid=n, prompt=(1, 2, 3, 4),
                                             max_new_tokens=4, arrival=t)],
                           now=t))
            for n, t in ((2, 5.0), (3, 13.0))]


def admit_finish(side):
    pol = side.policy(admission="fairshare")
    req = FakeReq(rid=1, tenant="t", prompt=tuple(range(10)),
                  max_new_tokens=6)
    pol.on_admit(req, now=0.0)
    st = pol.tenant("t")
    admitted = (st.concurrent, st.tokens_in_flight, st.accepted, st.service)
    pol.on_finish(req, now=1.0)
    return admitted, (st.concurrent, st.tokens_in_flight), \
        pol.snapshot()["t"]


def shed_wait(side):
    pol = side.policy(max_queue_wait_s=2.0)
    waiting = [FakeReq(rid=1, arrival=0.0), FakeReq(rid=2, arrival=9.0)]
    return victims(pol, waiting, 10.0)


def shed_depth_fifo(side):
    pol = side.policy(max_queue_depth=2)
    waiting = [FakeReq(rid=i, arrival=float(i)) for i in range(1, 6)]
    return victims(pol, waiting, 10.0), victims(pol, waiting, 10.0)


def shed_depth_fairshare(side):
    pol = side.policy(admission="fairshare", max_queue_depth=1,
                      fair_aging_tokens_per_s=0)
    cheap = FakeReq(rid=1, prompt=tuple(range(4)), max_new_tokens=2)
    dear = FakeReq(rid=2, prompt=tuple(range(400)), max_new_tokens=64)
    return victims(pol, [cheap, dear], 0.0)


def retry_after(side):
    pol = side.policy(max_queue_depth=2)
    waiting = [FakeReq(rid=i, arrival=float(i)) for i in range(1, 13)]
    return victims(pol, waiting, 20.0)


def reject_counters(side):
    pol = side.policy()
    pol.on_reject(FakeReq(rid=1, tenant="t"), now=0.0)
    pol.on_reject(FakeReq(rid=2, tenant="t"), now=0.0, timeout=True)
    st = pol.tenant("t")
    return st.rejected, st.timeouts


# ------------------------------------------------------------------- tests
def test_make_policy_dispatch():
    assert both(dispatch) == ["FIFOAdmission", "FairShareAdmission"]


def test_fifo_is_arrival_order():
    assert both(fifo_order) == 1


def test_fifo_head_of_line_blocks_on_budget():
    # FIFO is FIFO: the over-budget head blocks everyone behind it
    assert both(over_budget("fifo")) is None


def test_fairshare_skips_over_budget_tenant():
    assert both(over_budget("fairshare")) == 2


def test_wfq_prefers_underserved_tenant():
    # light arrived later but has zero virtual time -> wins
    assert both(underserved) == 2


def test_weights_scale_virtual_time():
    chosen, snap = both(weights)
    assert chosen == 2
    assert snap["premium"]["vtime"] == pytest.approx(100.0)
    assert snap["basic"]["vtime"] == pytest.approx(200.0)


def test_srpt_prefers_short_request_within_tenant():
    chosen, scores = both(srpt)
    assert chosen == 2 and scores[1] < scores[0]


def test_prefix_hit_discounts_cost():
    costs, chosen = both(prefix_hit)
    assert costs[1] < costs[0]
    assert chosen == 2


def test_aging_bounds_starvation():
    # pure SRPT would starve the big one; 50 tokens/s of aging credit
    # closes the 592-token gap after ~12 s of waiting
    assert both(aging) == [2, 1]


def test_admit_finish_accounting():
    admitted, after, snap = both(admit_finish)
    assert admitted[:3] == (1, 16, 1)
    assert admitted[3] == pytest.approx(16.0)  # zero hit prob: full cost
    assert after == (0, 0)
    assert snap["accepted"] == 1 and snap["vtime"] == pytest.approx(16.0)


def test_shed_wait_bound():
    got = both(shed_wait)
    assert [r for r, _ in got] == [1]
    assert all(ra >= 1.0 for _, ra in got)


def test_shed_depth_bound_fifo_newest_first():
    first, again = both(shed_depth_fifo)
    # 5 waiting, bound 2 -> 3 victims, newest arrivals first; the same
    # queue and clock give the same victims
    assert [r for r, _ in first] == [5, 4, 3]
    assert first == again


def test_shed_depth_bound_fairshare_worst_score_first():
    # the request fair share would admit LAST is shed first
    assert [r for r, _ in both(shed_depth_fairshare)] == [2]


def test_retry_after_scales_with_excess_depth():
    got = both(retry_after)
    # the first victim sees the full backlog (depth 12, bound 2 -> 5 s)
    assert got[0][1] == pytest.approx(0.5 * (12 - 2))
    hints = [ra for _, ra in got]
    assert hints[-1] >= 1.0
    assert hints == sorted(hints, reverse=True)


def test_reject_counters_split_timeouts():
    assert both(reject_counters) == (1, 1)
