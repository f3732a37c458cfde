"""The port's autotuner against byteps_tpu's (the classes of
``tests/test_autotune.py``): both packages' ``AutoTuner`` run the same
scripted sequence of synthetic views on the same clock and must reach the
same decisions, field for field (actions with their evidence, rollbacks,
map changes, the tuning state), and each sequence's decisions are the
ones the reference's tests expect.  Then the surfaces around the tuner:
``TuningState``, the books' extras and the ownership overrides, the PS
client's adoption, the engine's adoption and the server's hot report,
each on both packages.  Every comparison is exact.

Not here: ``TestQuotaDivision`` waits for the job namespaces (ROADMAP.md
Queue 1b item P12) and ``TestFlightUpload`` for the bundle upload (Queue 1
item 10).  The scheduler-hosted cases run against live fleets in
``test_torch_port_autotune_fleet.py``."""

import json
import socket
import threading

import pytest

import torch_port_kits as kits
from byteps_tpu.core import autotune as ref_autotune
from byteps_tpu_torch.core import autotune as port_autotune

MODS = {"port": port_autotune, "ref": ref_autotune}
PKGS = ["port", "ref"]


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    yield from kits.reset_runtime(monkeypatch)


def mk_tuner(mod, clock, reshard=True, **kw):
    cfg = dict(interval_s=0.1, factor=2.0, sweeps=2, cooldown_s=10.0, canary_sweeps=2,
               regress=1.3, budget=1, max_moves=2, quorum=0.5, bundle_dir="")
    cfg.update(kw)
    return mod.AutoTuner(cfg=mod.TunerConfig(**cfg), reshard=reshard, now_fn=lambda: clock[0])


def hot_view(load0=1000.0, load1=100.0, steps=None):
    return {"server_ranks": [0, 1], "num_workers": 2,
            "steps": dict(steps if steps is not None else {"w0": 0.1, "w1": 0.1}),
            "server_load": {0: load0, 1: load1},
            "hot_keys": {0: [(65536, load0 * 0.7), (131072, load0 * 0.2)]},
            "fusion": {}, "codec_votes": {}}


def fusion_view(thr, rpc, fused, keys, dwell=None, steps=None):
    f = {"threshold": thr, "wire_rpc": rpc, "fused_frames": fused, "fused_keys": keys}
    if dwell is not None:
        f["dwell"] = dwell
    return {"steps": dict(steps or {}), "num_workers": 2, "codec_votes": {}, "fusion": f}


def codec_view(votes, nw, lz=None):
    v = {"steps": {}, "fusion": {}, "codec_votes": votes, "num_workers": nw}
    if lz is not None:
        v["codec_lossless_votes"] = lz
    return v


# --- the scripted sequences ------------------------------------------------
#
# Each takes a package's module and returns (tuner, [sweep results]); the
# views are rebuilt for each package, so neither can see the other's.


def seq_rebalance_fires(mod):
    t = mk_tuner(mod, [0.0])
    return t, [t.sweep(hot_view()), t.sweep(hot_view())]


def seq_below_factor(mod):
    t = mk_tuner(mod, [0.0])
    return t, [t.sweep(hot_view(load0=150.0)) for _ in range(5)]


def seq_calm_resets_streak(mod):
    t = mk_tuner(mod, [0.0])
    return t, [t.sweep(hot_view()), t.sweep(hot_view(load0=100.0)), t.sweep(hot_view())]


def seq_reshard_off(mod):
    t = mk_tuner(mod, [0.0], reshard=False)
    return t, [t.sweep(hot_view()) for _ in range(5)]


def seq_cooldown(mod):
    clock = [0.0]
    t = mk_tuner(mod, clock, cooldown_s=10.0, canary_sweeps=100)
    out = [t.sweep(hot_view()), t.sweep(hot_view())]
    v = hot_view()
    v["hot_keys"] = {0: [(999 << 16, 500.0)]}
    out += [t.sweep(v) for _ in range(4)]
    clock[0] = 11.0
    out += [t.sweep(v), t.sweep(v)]
    return t, out


def seq_max_moves(mod):
    t = mk_tuner(mod, [0.0], max_moves=1)
    return t, [t.sweep(hot_view()), t.sweep(hot_view())]


def seq_dead_target_pruned(mod):
    t = mk_tuner(mod, [0.0])
    out = [t.sweep(hot_view()), t.sweep(hot_view())]
    v = hot_view()
    v["server_ranks"] = [0, 2]
    return t, out + [t.sweep(v)]


def _fusion(mod, before, after, **kw):
    t = mk_tuner(mod, [0.0], cooldown_s=0.0, **kw)
    return t, [t.sweep(before), t.sweep(after)]


def seq_fusion_grow(mod):
    return _fusion(mod, fusion_view(65536, 0, 0, 0), fusion_view(65536, 500, 10, 100))


def seq_fusion_shrink(mod):
    return _fusion(mod, fusion_view(65536, 0, 0, 0), fusion_view(65536, 100, 100, 110))


def seq_fusion_dwell_vetoes_grow(mod):
    return _fusion(mod, fusion_view(65536, 0, 0, 0, dwell={"PUSH": 0.0, "COPYD2H": 0.0}),
                   fusion_view(65536, 500, 10, 100, dwell={"PUSH": 0.01, "COPYD2H": 10.0}))


def seq_fusion_dwell_confirms_grow(mod):
    return _fusion(mod, fusion_view(65536, 0, 0, 0, dwell={"PUSH": 0.0, "COPYD2H": 0.0}),
                   fusion_view(65536, 500, 10, 100, dwell={"PUSH": 8.0, "COPYD2H": 2.0}))


def seq_fusion_dwell_vetoes_shrink(mod):
    return _fusion(mod, fusion_view(65536, 0, 0, 0, dwell={"PUSH": 0.0, "FUSE": 0.0}),
                   fusion_view(65536, 100, 100, 110, dwell={"PUSH": 10.0, "FUSE": 0.001}))


def seq_fusion_dwell_deltas(mod):
    return _fusion(mod, fusion_view(65536, 0, 0, 0, dwell={"PUSH": 8.0, "COPYD2H": 2.0}),
                   fusion_view(65536, 500, 10, 100, dwell={"PUSH": 8.0, "COPYD2H": 2.0}))


def seq_fusion_rollback_concrete(mod):
    t = mk_tuner(mod, [0.0], cooldown_s=0.0, canary_sweeps=1)
    return t, [t.sweep(fusion_view(65536, 0, 0, 0, steps={"w0": 0.1})),
               t.sweep(fusion_view(65536, 500, 10, 100, steps={"w0": 0.1})),
               t.sweep(fusion_view(65536, 0, 0, 0, steps={"w0": 9.0}))]


def seq_fusion_hysteresis(mod):
    return _fusion(mod, fusion_view(65536, 0, 0, 0), fusion_view(65536, 30, 10, 30))


def seq_fusion_never_on_from_zero(mod):
    return _fusion(mod, fusion_view(0, 0, 0, 0), fusion_view(0, 5000, 0, 0))


def seq_fusion_bounds(mod):
    t = mk_tuner(mod, [0.0], cooldown_s=0.0, canary_sweeps=1000)
    t.state.fusion_threshold = mod.TunerConfig().fusion_max
    return t, [t.sweep(fusion_view(0, 0, 0, 0)), t.sweep(fusion_view(0, 5000, 0, 0))]


def seq_codec_quorum(mod):
    t = mk_tuner(mod, [0.0])
    return t, [t.sweep(codec_view({"topk": 2}, 3))]


def seq_codec_below_quorum(mod):
    t = mk_tuner(mod, [0.0])
    return t, [t.sweep(codec_view({"topk": 1}, 4))]


def seq_codec_single_worker(mod):
    t = mk_tuner(mod, [0.0])
    return t, [t.sweep(codec_view({"topk": 1}, 1))]


def seq_codec_not_reflipped(mod):
    t = mk_tuner(mod, [0.0], cooldown_s=0.0)
    return t, [t.sweep(codec_view({"topk": 2}, 2)), t.sweep(codec_view({"topk": 2}, 2))]


def seq_lossless_quorum(mod):
    t = mk_tuner(mod, [0.0])
    return t, [t.sweep(codec_view({}, 3, lz={"topk": 2}))]


def seq_lossless_below_quorum(mod):
    t = mk_tuner(mod, [0.0])
    return t, [t.sweep(codec_view({}, 4, lz={"topk": 1}))]


def seq_lossless_off_votes_first(mod):
    t = mk_tuner(mod, [0.0])
    return t, [t.sweep(codec_view({"topk": 2}, 2, lz={"onebit": 2}))]


def seq_lossless_not_reflipped(mod):
    t = mk_tuner(mod, [0.0], cooldown_s=0.0)
    return t, [t.sweep(codec_view({}, 2, lz={"topk": 2})),
               t.sweep(codec_view({}, 2, lz={"topk": 2}))]


def seq_lossless_forced_rollback(mod):
    t = mk_tuner(mod, [0.0], canary_sweeps=1, force="codec_lossless=topk")
    base = {"steps": {"w0": 0.1}, "fusion": {}, "codec_votes": {},
            "codec_lossless_votes": {}, "num_workers": 1}
    return t, [t.sweep(dict(base)), t.sweep({**base, "steps": {"w0": 9.9}})]


def seq_canary_regression(mod):
    t = mk_tuner(mod, [0.0], canary_sweeps=2)
    slow = {"w0": 0.5, "w1": 0.5}
    return t, [t.sweep(hot_view()), t.sweep(hot_view()),
               t.sweep(hot_view(load0=100.0, steps=slow)),
               t.sweep(hot_view(load0=100.0, steps=slow))]


def seq_canary_healthy(mod):
    t = mk_tuner(mod, [0.0], canary_sweeps=2)
    return t, [t.sweep(hot_view()), t.sweep(hot_view())] + [
        t.sweep(hot_view(load0=100.0)) for _ in range(4)]


def seq_canary_no_baseline(mod):
    t = mk_tuner(mod, [0.0], canary_sweeps=1)
    v = hot_view(steps={})
    return t, [t.sweep(v), t.sweep(v),
               t.sweep(hot_view(load0=100.0, steps={"w0": 99.0, "w1": 99.0}))]


def seq_canary_forced_fusion(mod):
    t = mk_tuner(mod, [0.0], canary_sweeps=1, force="fusion_threshold=65536")
    base = {"steps": {"w0": 0.1}, "fusion": {}, "codec_votes": {}, "num_workers": 1}
    return t, [t.sweep(dict(base)), t.sweep({**base, "steps": {"w0": 9.9}})]


def seq_forced_move_and_codec(mod):
    """The drill the card's phase (e) runs: a forced move, then consensus."""
    t = mk_tuner(mod, [0.0], canary_sweeps=3, force="move=655360:1")
    v = {**codec_view({"topk": 2}, 2), "server_ranks": [0, 1], "steps": {"w0": 0.2}}
    return t, [t.sweep(dict(v)), t.sweep(dict(v)), t.sweep(dict(v))]


def seq_malformed_force(mod):
    t = mk_tuner(mod, [0.0], force="move=notakey:1")
    return t, [t.sweep(hot_view(load0=100.0)) for _ in range(2)]


def _assert_rebalance_fires(t, res):
    assert not res[0]["actions"]
    assert [a["rule"] for a in res[1]["actions"]] == ["hot_key_rebalance"]
    assert res[1]["map_changed"] and t.state.overrides == {65536: 1, 131072: 1}
    assert res[1]["actions"][0]["evidence"]["target"] == 1


def _no_actions(t, res):
    assert not any(r["actions"] for r in res)


EXPECT = {
    seq_rebalance_fires: _assert_rebalance_fires,
    seq_below_factor: _no_actions,
    seq_calm_resets_streak: _no_actions,
    seq_reshard_off: _no_actions,
    seq_cooldown: lambda t, r: (
        [bool(x["actions"]) for x in r] == [False, True] + [False] * 4 + [False, True]),
    seq_max_moves: lambda t, r: t.state.overrides == {65536: 1},
    seq_dead_target_pruned: lambda t, r: (not t.state.overrides and r[2]["map_changed"]),
    seq_fusion_grow: lambda t, r: r[1]["actions"][0]["set"]["fusion_threshold"] == 131072,
    seq_fusion_shrink: lambda t, r: r[1]["actions"][0]["set"]["fusion_threshold"] == 32768,
    seq_fusion_dwell_vetoes_grow: _no_actions,
    seq_fusion_dwell_confirms_grow: lambda t, r: (
        r[1]["actions"][0]["evidence"]["dwell_wire_s"] > 0),
    seq_fusion_dwell_vetoes_shrink: _no_actions,
    seq_fusion_dwell_deltas: lambda t, r: (
        r[1]["actions"][0]["set"]["fusion_threshold"] == 131072),
    seq_fusion_rollback_concrete: lambda t, r: (
        r[1]["actions"][0]["undo"] == {"fusion_threshold": 65536} and r[2]["rollbacks"]
        and t.state.fusion_threshold == 65536),
    seq_fusion_hysteresis: _no_actions,
    seq_fusion_never_on_from_zero: _no_actions,
    seq_fusion_bounds: _no_actions,
    seq_codec_quorum: lambda t, r: (
        r[0]["actions"][0]["set"] == {"codec_off_add": ["topk"]}
        and t.tuning_dict()["codec_off"] == ["topk"]),
    seq_codec_below_quorum: _no_actions,
    seq_codec_single_worker: _no_actions,
    seq_codec_not_reflipped: lambda t, r: not r[1]["actions"],
    seq_lossless_quorum: lambda t, r: (
        r[0]["actions"][0]["evidence"]["arm"] == "lossless"
        and t.tuning_dict()["codec_lossless"] == ["topk"]),
    seq_lossless_below_quorum: _no_actions,
    seq_lossless_off_votes_first: lambda t, r: (
        r[0]["actions"][0]["set"] == {"codec_off_add": ["topk"]}),
    seq_lossless_not_reflipped: lambda t, r: not r[1]["actions"],
    seq_lossless_forced_rollback: lambda t, r: (
        r[1]["rollbacks"] and t.state.codec_lossless == []
        and "codec_lossless" not in t.tuning_dict()),
    seq_canary_regression: lambda t, r: (
        [c["rule"] for c in r[3]["rollbacks"]] == ["hot_key_rebalance"]
        and r[3]["map_changed"] and not t.state.overrides
        and t._cooldown_mult["hot_key_rebalance"] == 4.0),
    seq_canary_healthy: lambda t, r: (
        not any(x["rollbacks"] for x in r) and bool(t.state.overrides)),
    seq_canary_no_baseline: lambda t, r: (not r[2]["rollbacks"] and bool(t.state.overrides)),
    seq_canary_forced_fusion: lambda t, r: (
        r[0]["actions"][0]["rule"] == "fusion_threshold" and r[1]["rollbacks"]
        and t.state.fusion_threshold is None),
    seq_forced_move_and_codec: lambda t, r: (
        [a["rule"] for x in r for a in x["actions"]]
        == ["hot_key_rebalance", "codec_consensus"]
        and t.state.overrides == {655360: 1} and t.state.codec_off == ["topk"]
        and r[0]["map_changed"]),
    seq_malformed_force: _no_actions,
}


def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, default=str)


def _state(t) -> dict:
    st = t.state
    return {"epoch": st.epoch, "fusion_threshold": st.fusion_threshold,
            "codec_off": st.codec_off, "codec_lossless": st.codec_lossless,
            "overrides": st.overrides, "tuning": t.tuning_dict(),
            "book": t.book_extras([0, 1]), "cooldown": t._cooldown_mult}


@pytest.mark.parametrize("seq", list(EXPECT), ids=lambda f: f.__name__[4:])
def test_equal_views_reach_equal_decisions(seq):
    port_t, port_res = seq(port_autotune)
    ref_t, ref_res = seq(ref_autotune)
    ok = EXPECT[seq](port_t, port_res)
    assert ok is None or ok, [r["actions"] for r in port_res]
    assert _canon(port_res) == _canon(ref_res)
    assert _canon(_state(port_t)) == _canon(_state(ref_t))
    assert _canon(port_t.actions) == _canon(ref_t.actions)
    assert _canon(port_t.rollbacks) == _canon(ref_t.rollbacks)


def test_the_rules_are_the_references():
    assert port_autotune.TUNE_RULES == ref_autotune.TUNE_RULES
    assert port_autotune.TUNE_RULES == ("hot_key_rebalance", "fusion_threshold",
                                        "codec_consensus")


def test_the_config_reads_the_environment_as_the_reference(monkeypatch):
    for k, v in {"BYTEPS_AUTOTUNE_INTERVAL_S": "0.2", "BYTEPS_AUTOTUNE_FACTOR": "1.5",
                 "BYTEPS_AUTOTUNE_SWEEPS": "4", "BYTEPS_AUTOTUNE_COOLDOWN_S": "7",
                 "BYTEPS_AUTOTUNE_CANARY_SWEEPS": "3", "BYTEPS_AUTOTUNE_REGRESS": "1.1",
                 "BYTEPS_AUTOTUNE_BUDGET": "2", "BYTEPS_AUTOTUNE_MAX_MOVES": "3",
                 "BYTEPS_AUTOTUNE_QUORUM": "0.75", "BYTEPS_AUTOTUNE_FORCE": "move=1:0",
                 "BYTEPS_FLIGHT_DIR": "/x"}.items():
        monkeypatch.setenv(k, v)
    assert port_autotune.TunerConfig.from_env().__dict__ == \
        ref_autotune.TunerConfig.from_env().__dict__
    for off in ("", "0", "off"):
        monkeypatch.setenv("BYTEPS_AUTOTUNE", off)
        assert not port_autotune.tuner_enabled() and not ref_autotune.tuner_enabled()
    monkeypatch.setenv("BYTEPS_AUTOTUNE", "1")
    assert port_autotune.tuner_enabled() and ref_autotune.tuner_enabled()


@pytest.mark.parametrize("kind", ["action", "rollback"])
def test_a_decision_writes_its_bundle(tmp_path, kind):
    """Each action and rollback writes ``decision.json`` under the bundle
    dir, with the baseline (None when no worker step was seen)."""
    t = mk_tuner(port_autotune, [0.0], canary_sweeps=1, bundle_dir=str(tmp_path),
                 force="fusion_threshold=65536")
    base = {"steps": {"w0": 0.1}, "fusion": {}, "codec_votes": {}, "num_workers": 1}
    t.sweep(dict(base))
    t.sweep({**base, "steps": {"w0": 9.9}})
    found = sorted(tmp_path.glob(f"*-tune-{kind}-fusion_threshold-*/decision.json"))
    assert len(found) == 1
    body = json.loads(found[0].read_text())
    assert body["kind"] == kind and body["baseline_step_s"] == 0.1
    if kind == "rollback":
        assert body["post_step_s"] == 9.9


def test_no_step_seen_is_written_as_no_baseline(tmp_path):
    t = mk_tuner(port_autotune, [0.0], bundle_dir=str(tmp_path), force="codec_off=topk")
    t.sweep({"steps": {}, "fusion": {}, "codec_votes": {}, "num_workers": 1})
    (found,) = tmp_path.glob("*-tune-action-codec_consensus-*/decision.json")
    assert json.loads(found.read_text())["baseline_step_s"] is None


# --- TuningState, the books' extras, the overrides --------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_the_epoch_bumps_on_every_patch(pkg):
    st = MODS[pkg].TuningState()
    assert not st.apply_patch({"fusion_threshold": 1024})
    assert st.epoch == 1
    assert st.apply_patch({"overrides_set": {5: 1}})
    assert st.epoch == 2 and st.overrides == {5: 1}
    assert st.apply_patch({"overrides_del": [5]})
    assert not st.overrides and st.epoch == 3


@pytest.mark.parametrize("pkg", PKGS)
def test_book_extras_filter_overrides_to_the_books_ranks(pkg):
    t = mk_tuner(MODS[pkg], [0.0])
    t.state.apply_patch({"overrides_set": {7: 1, 9: 2}})
    assert t.book_extras([0, 1]) == {"tuning": {"epoch": 1}, "ring_overrides": {"7": 1}}
    assert t.book_extras([0]) == {"tuning": {"epoch": 1}}


@pytest.mark.parametrize("pkg", PKGS)
def test_a_rejoin_report_is_adopted_monotonically(pkg):
    t = mk_tuner(MODS[pkg], [0.0])
    assert t.adopt_rejoin_report({"epoch": 7, "fusion_threshold": 131072,
                                  "codec_off": ["topk"], "codec_lossless": ["onebit"],
                                  "ring_overrides": {"65536": 1}})
    assert (t.state.epoch, t.state.fusion_threshold, t.state.codec_off,
            t.state.codec_lossless, t.state.overrides) == (
        7, 131072, ["topk"], ["onebit"], {65536: 1})
    assert not t.adopt_rejoin_report({"epoch": 6, "fusion_threshold": 1})
    assert not t.adopt_rejoin_report("garbage")
    assert not t.adopt_rejoin_report({"epoch": "x"})
    assert t.book_extras([1]) == {"tuning": {"epoch": 7, "fusion_threshold": 131072,
                                             "codec_off": ["topk"],
                                             "codec_lossless": ["onebit"]},
                                  "ring_overrides": {"65536": 1}}


def test_the_ownership_overrides_route_as_the_reference():
    from byteps_tpu.common import hashing as rhash
    from byteps_tpu_torch.common import hashing as phash

    ring = phash.HashRing([0, 1])
    key = next(k << 16 for k in range(256) if ring.owner(k << 16) == 0)
    for over in ({key: 1}, {key: 7}, {str(key): "1"}):
        pm = phash.OwnershipMap([0, 1], epoch=3, overrides=over)
        rm = rhash.OwnershipMap([0, 1], epoch=3, overrides=over)
        assert pm.overrides == rm.overrides
        keys = [key] + [k << 16 for k in range(64)]
        assert [pm.owner(k) for k in keys] == [rm.owner(k) for k in keys]
    assert phash.OwnershipMap([0, 1], overrides={key: 1}).owner(key) == 1


# --- the PS client's adoption ---------------------------------------------


def _stub_client(pkg: str):
    k = kits.kit(pkg)
    pc = k.PSClient.__new__(k.PSClient)
    pc._tuning_listeners = []
    pc.tuning = None
    pc._tuning_epoch = 0
    pc._seen_ring_overrides = {}
    pc.sched_incarnation = 0
    return pc


@pytest.mark.parametrize("pkg", PKGS)
def test_the_client_adopts_monotonically_and_replays_to_a_late_listener(pkg):
    pc = _stub_client(pkg)
    seen = []
    pc.add_tuning_listener(seen.append)
    pc._adopt_tuning({"tuning": {"epoch": 2, "fusion_threshold": 512}})
    pc._adopt_tuning({"tuning": {"epoch": 1}})  # stale
    pc._adopt_tuning({})  # a book with no section reverts once
    pc._adopt_tuning({"tuning": "garbage"})
    pc._adopt_tuning({"tuning": {"epoch": 3, "codec_off": ["topk"]}})
    assert seen == [{"epoch": 2, "fusion_threshold": 512}, {},
                    {"epoch": 3, "codec_off": ["topk"]}]
    late = []
    pc.add_tuning_listener(late.append)
    assert late == [{"epoch": 3, "codec_off": ["topk"]}]


@pytest.mark.parametrize("pkg", PKGS)
def test_the_rejoin_report_carries_the_section_and_the_overrides(pkg):
    pc = _stub_client(pkg)
    assert pc._tuning_report() is None
    pc._adopt_tuning({"tuning": {"epoch": 4, "fusion_threshold": 8192}})
    pc._seen_ring_overrides = {"65536": 1}
    assert pc._tuning_report() == {"epoch": 4, "fusion_threshold": 8192,
                                   "ring_overrides": {"65536": 1}}


@pytest.mark.parametrize("pkg", PKGS)
def test_a_scheduler_rebirth_rearms_the_tuning_fence(pkg):
    pc = _stub_client(pkg)
    assert pc._fence_book({"sched_incarnation": 100})
    pc._adopt_tuning({"tuning": {"epoch": 10, "codec_off": ["topk"]}})
    assert pc._fence_book({"sched_incarnation": 200})
    assert pc._tuning_epoch == -1
    pc._adopt_tuning({"tuning": {"epoch": 0}})
    assert pc.tuning == {"epoch": 0} and pc._tuning_epoch == 0
    assert not pc._fence_book({"sched_incarnation": 150})  # a zombie


@pytest.mark.parametrize("pkg", PKGS)
def test_a_tunerless_successor_reverts_once(pkg):
    pc = _stub_client(pkg)
    seen = []
    pc.add_tuning_listener(seen.append)
    pc._adopt_tuning({"tuning": {"epoch": 3, "codec_off": ["topk"]}})
    pc._adopt_tuning({"epoch": 9})
    pc._adopt_tuning({"epoch": 10})
    assert pc.tuning is None and seen == [{"epoch": 3, "codec_off": ["topk"]}, {}]


# --- the engine's adoption ------------------------------------------------


def _engine(pkg: str, **cfg_kw):
    k = kits.kit(pkg)
    return k.PipelineEngine(k.Config(num_worker=1, **cfg_kw), object())


def _fusion_after(pkg, launch, sections):
    eng = _engine(pkg, fusion_threshold=launch)
    out = []
    for t in sections:
        eng._apply_tuning(t)
        out.append(eng.cfg.fusion_threshold)
    return out


@pytest.mark.parametrize("case", ["live", "never_on_from_zero", "absent_restores_launch"])
def test_the_engine_adopts_the_fusion_threshold_as_the_reference(case):
    launch, sections, expect = {
        "live": (65536, [{"epoch": 1, "fusion_threshold": 131072}], [131072]),
        "never_on_from_zero": (0, [{"epoch": 1, "fusion_threshold": 65536}], [0]),
        "absent_restores_launch": (65536, [{"epoch": 1, "fusion_threshold": 131072},
                                           {"epoch": 2}, {}], [131072, 65536, 65536]),
    }[case]
    assert _fusion_after("port", launch, sections) == expect
    assert _fusion_after("ref", launch, sections) == expect


def test_a_fleet_codec_off_and_its_rollback_touch_only_the_fleets_keys():
    from byteps_tpu_torch.core.telemetry import counters

    got = {}
    for pkg in PKGS:
        eng = _engine(pkg)
        eng._codec_names = {1: "topk", 2: "topk", 3: "onebit"}
        eng._compression_auto_off.add(2)  # a verdict of this worker
        before = kits.kit(pkg).counters().get("tune_codec_off")
        eng._apply_tuning({"epoch": 1, "codec_off": ["topk"],
                           "codec_lossless": ["topk"]})
        flipped = (set(eng._compression_auto_off), dict(eng._fleet_codec_off),
                   kits.kit(pkg).counters().get("tune_codec_off") - before)
        eng._apply_tuning({"epoch": 2, "codec_off": []})
        got[pkg] = (flipped, set(eng._compression_auto_off), dict(eng._fleet_codec_off))
    assert got["port"] == got["ref"] == (({1, 2}, {"topk": {1}}, 1), {2}, {})
    assert counters().snapshot_labeled()["tune_codec_off"]['{codec="topk"}'] >= 1


def test_the_port_ignores_codec_lossless(monkeypatch):
    """With ``BYTEPS_WIRE_LOSSLESS`` off both engines ignore a section's
    codec_lossless; with it on both put exactly the named codec's off keys
    in the lossless arm, and a rollback takes exactly those out (a key
    the probe put there stays)."""
    got = {}
    for pkg in PKGS:
        row = []
        for switch in ("0", "1"):
            monkeypatch.setenv("BYTEPS_WIRE_LOSSLESS", switch)
            eng = _engine(pkg)
            eng._codec_names = {1: "topk", 2: "topk", 3: "topk", 4: "onebit"}
            eng._compression_auto_off.update({1, 2, 4})
            eng._lossless_keys.add(2)  # a probe's verdict
            eng._apply_tuning({"epoch": 1, "codec_lossless": ["topk"]})
            adopted = (set(eng._lossless_keys), dict(eng._fleet_codec_lossless))
            eng._apply_tuning({"epoch": 2})
            row.append((adopted, set(eng._lossless_keys), set(eng._compression_auto_off)))
        got[pkg] = row
    assert got["port"] == got["ref"] == [
        (({2}, {}), {2}, {1, 2, 4}),
        (({1, 2}, {"topk": {1}}), {2}, {1, 2, 4}),
    ]


# --- the server's hot report ----------------------------------------------


def _server(pkg: str):
    k = kits.kit(pkg)
    return k.PSServer(k.Config(num_worker=1, num_server=1))


@pytest.mark.parametrize("pkg", PKGS)
def test_a_tuning_book_arms_the_hot_report_with_deltas(pkg):
    srv = _server(pkg)
    try:
        ks = srv._key_state(7 << 16)
        ks.req_bytes = 1000
        assert srv._hot_report() is None
        srv._adopt_tuning({"tuning": {"epoch": 0}})
        assert srv._hot_report() == {"total": 0, "keys": [], "owned": 0}
        ks.req_bytes += 500
        assert srv._hot_report() == {"total": 500, "keys": [[7 << 16, 500]], "owned": 0}
        srv._adopt_tuning({"epoch": 5})  # a book without the section
        assert not srv._tuning_on and srv._hot_report() is None
    finally:
        srv.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_enqueue_counts_the_request_bytes(pkg):
    k = kits.kit(pkg)
    srv = _server(pkg)
    a, b = socket.socketpair()
    try:
        msg = k.tr.Message(k.tr.Op.PUSH, key=3, payload=b"x" * 64, flags=1,
                                  version=1)
        srv._enqueue(msg, a, threading.Lock())
        assert srv._key_state(3).req_bytes == 64
    finally:
        a.close()
        b.close()
        srv.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_the_hot_report_names_the_eight_hottest(pkg):
    srv = _server(pkg)
    try:
        srv._adopt_tuning({"tuning": {"epoch": 0}})
        for i in range(12):
            srv._key_state(i << 16).req_bytes = (i + 1) * 10
        rep = srv._hot_report()
        assert rep["total"] == sum((i + 1) * 10 for i in range(12))
        assert [k for k, _ in rep["keys"]] == [i << 16 for i in range(11, 3, -1)]
    finally:
        srv.stop()
