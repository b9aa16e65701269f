"""The port's rollout gate (``fedml_tpu_torch/serve/rollout.py``) against
the JAX package's (``fedml_tpu/serve/rollout.py``): the promote / block /
poison / rollback / restart drills of ``tests/test_serve.py:441-533`` run
on both coordinators over the same base, adapters and traffic (the
``jstack``/``stack`` pair of ``tests/test_torch_serve.py``). The port is
held to what the JAX coordinator outputs on the same arms — the same
verdict and reason, the same token count, each arm's CE within 1e-4 —
and a rollback restores the displaced version bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.comm.codec import tree_to_vector_np as jax_vec
from fedml_tpu.serve import ServeManager as JaxManager
from fedml_tpu.serve.rollout import RolloutCoordinator as JaxCoordinator
from fedml_tpu.serve.rollout import StaleEpochError as JaxStaleEpochError
from fedml_tpu.sim.clock import VirtualClock
from fedml_tpu_torch.core.flat import tree_to_vector_np, vector_to_tree_np
from fedml_tpu_torch.serve import (RolloutCoordinator, ServeManager,
                                   StaleEpochError)
from test_torch_serve import T, _jax_side, _port_side

CE_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jstack():
    _, fns, glob = _jax_side("dense")
    from fedml_tpu.serve import ServeForward as JaxForward

    return {"fns": fns, "glob": glob, "fwd": JaxForward(fns, glob)}


@pytest.fixture(scope="module")
def stack(jstack):
    return _port_side("dense", jstack["fns"].holder["base"], jstack["glob"])


def _randomized(adapters, seed, scale):
    """The JAX test's arm: normal adapters of ``scale`` from ``seed``."""
    leaves, treedef = jax.tree.flatten(adapters)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree.unflatten(treedef, [
        np.asarray(jax.random.normal(k, l.shape, l.dtype) * scale)
        for k, l in zip(keys, leaves)])


def _arms(jstack, stack, jtree):
    """One JAX adapter tree as both packages take it (the flat rows of
    both are the same vectors)."""
    return jtree, vector_to_tree_np(jax_vec(jtree), stack["fwd"].spec)


def _managers(jstack, stack, jlive=None, clock=False):
    jlive = jstack["glob"] if jlive is None else jlive
    _, live = _arms(jstack, stack, jlive)
    kw = dict(seq_len=T, max_batch=4)
    jmgr = JaxManager(jstack["fwd"], None, jlive,
                      clock=VirtualClock() if clock else None, **kw)
    mgr = ServeManager(stack["fwd"], None, live, device="cpu",
                       clock=VirtualClock() if clock else None, **kw)
    return jmgr, mgr


def _drive_shadow(mgr, n=4):
    """Mirrored traffic through an unstarted manager, served
    synchronously."""
    for _ in range(n):
        req = mgr.submit(0, [1, 2, 3, 4, 5])
        mgr.serve_batch([mgr._q.get_nowait()])
        req.result(5)


def _same_verdict(got, want):
    assert got["promoted"] == want["promoted"]
    assert got["reason"].split(" ")[0] == want["reason"].split(" ")[0]
    if "tokens" in want:
        assert got["tokens"] == want["tokens"]
        assert got["candidate_version"] == want["candidate_version"]
        for key in ("live_ce", "cand_ce"):
            if np.isfinite(want[key]):
                assert got[key] == pytest.approx(want[key], abs=CE_TOL)
            else:
                assert not np.isfinite(got[key])


def test_gate_promotes_blocks_poison_rolls_back(jstack, stack, tmp_path):
    """The full drill on both coordinators: too little traffic blocks, the
    mirrored candidate's verdict, a NaN-poisoned candidate blocked and
    never live, discard, and a rollback bit-equal to the displaced live
    vector — reversible."""
    jmgr, mgr = _managers(jstack, stack)
    jco = JaxCoordinator(jmgr, directory=str(tmp_path / "jax"),
                         min_shadow_tokens=8)
    co = RolloutCoordinator(mgr, directory=str(tmp_path / "port"),
                            min_shadow_tokens=8)
    before = mgr._vec(mgr.live_adapters()).copy()
    jcand, cand = _arms(jstack, stack, _randomized(jstack["glob"], 11, 0.04))
    assert co.publish(cand, epoch=1) == jco.publish(jcand, epoch=1) == 1
    with pytest.raises(StaleEpochError):
        co.publish(cand, epoch=1)
    with pytest.raises(JaxStaleEpochError):
        jco.publish(jcand, epoch=1)
    _same_verdict(co.try_promote(), jco.try_promote())  # no traffic yet
    for m in (jmgr, mgr):
        _drive_shadow(m)
    want, got = jco.try_promote(), co.try_promote()
    _same_verdict(got, want)
    assert mgr.live_version == jmgr.live_version
    if not got["promoted"]:  # the JAX verdict on these arms: force it
        co.regression_tol = jco.regression_tol = 1e9
        _same_verdict(co.try_promote(), jco.try_promote())
    assert mgr.live_version == 1
    promoted = mgr._vec(mgr.live_adapters()).copy()
    assert np.array_equal(promoted, tree_to_vector_np(cand))
    jbad, bad = _arms(jstack, stack, jax.tree.map(
        lambda x: jnp.full_like(x, jnp.nan), jstack["glob"]))
    co.publish(bad, epoch=2)
    jco.publish(jbad, epoch=2)
    for m in (jmgr, mgr):
        _drive_shadow(m)
    want, got = jco.try_promote(), co.try_promote()
    _same_verdict(got, want)
    assert got["reason"] == "candidate_ce_not_finite"
    assert mgr.live_version == 1
    co.discard()
    jco.discard()
    assert co.rollback() == jco.rollback() == 0
    assert np.array_equal(mgr._vec(mgr.live_adapters()), before)
    co.rollback()
    assert np.array_equal(mgr._vec(mgr.live_adapters()), promoted)
    for c in (co, jco):
        c.close()


@pytest.mark.parametrize("live_arm,cand_arm", [
    ((99, 5.0), None),            # tests/test_serve.py's arms
    (None, (99, 5.0)),
    (None, (7, 0.5)),
    ((5, 0.04), (6, 0.04)),
])
def test_regression_gate_verdicts_match_jax(jstack, stack, live_arm,
                                            cand_arm):
    """A finite candidate against the live arm under the relative gate
    (tol 0.02): the port gives the JAX coordinator's verdict, reason and
    CEs on the same arms (``None`` is the fixture's global)."""
    def arm(spec):
        return (jstack["glob"] if spec is None
                else _randomized(jstack["glob"], *spec))

    jmgr, mgr = _managers(jstack, stack, arm(live_arm))
    jco = JaxCoordinator(jmgr, min_shadow_tokens=8, regression_tol=0.02)
    co = RolloutCoordinator(mgr, min_shadow_tokens=8, regression_tol=0.02)
    jcand, cand = _arms(jstack, stack, arm(cand_arm))
    jco.publish(jcand, epoch=1)
    co.publish(cand, epoch=1)
    for m in (jmgr, mgr):
        _drive_shadow(m)
    want, got = jco.try_promote(), co.try_promote()
    _same_verdict(got, want)
    if want["reason"].startswith("regression"):
        assert got["cand_ce"] > got["live_ce"] * 1.02


def test_restart_resumes_mid_promotion(jstack, stack, tmp_path):
    """A coordinator dies between publish and promote: the next
    incarnation restores the fenced epoch and re-stages the candidate,
    a publish under the dead epoch raises, and its verdict is JAX's; a
    third incarnation restores what the second left live, bit-equal."""
    jcand, cand = _arms(jstack, stack, _randomized(jstack["glob"], 11, 0.04))
    results = []
    for side in ("jax", "port"):
        d = str(tmp_path / side)
        Coord = JaxCoordinator if side == "jax" else RolloutCoordinator
        stale = JaxStaleEpochError if side == "jax" else StaleEpochError
        c = jcand if side == "jax" else cand

        def manager():
            pair = _managers(jstack, stack, clock=True)
            return pair[0] if side == "jax" else pair[1]

        co = Coord(manager(), directory=d, min_shadow_tokens=8)
        v = co.publish(c, epoch=3)
        co.close()
        mgr2 = manager()
        co2 = Coord(mgr2, directory=d, min_shadow_tokens=8)
        assert co2.fence_epoch == 3 and co2.cand_version == v
        assert mgr2.shadow_scores()["candidate_version"] == v
        with pytest.raises(stale):
            co2.publish(c, epoch=3)
        _drive_shadow(mgr2)
        verdict = co2.try_promote()
        live2 = np.asarray(mgr2._vec(mgr2.live_adapters())).copy()
        co2.close()
        mgr3 = manager()
        co3 = Coord(mgr3, directory=d)
        assert co3.live_version == co2.live_version
        assert co3.cand_version == co2.cand_version
        assert np.array_equal(mgr3._vec(mgr3.live_adapters()), live2)
        co3.close()
        results.append((verdict, co2.live_version, live2))
    (want, jlive_v, jlive), (got, live_v, live) = results
    _same_verdict(got, want)
    assert live_v == jlive_v
    np.testing.assert_array_equal(live, jlive)
