"""PyTorch port: the roofline package (``repro_torch.roofline``) held
against the JAX package's ``repro.roofline``.

(a) ``analysis.py``: ``model_flops`` equals the reference's float for float
    for every assigned arch x shape, ``ranklocal_savings`` on the report's
    rank-sweep mix for every arch; ``Roofline``'s properties on a fixed
    record, ``from_dryrun`` on a fixed dict (counts equal, each term scaled
    by the ratio of the two packages' constants), ``load_all`` over a tree
    of records. The constants are the H100's.
(b) ``hlo.py``: the ring model (``_traffic``), ``summarize`` and
    ``total_traffic`` equal the reference's on the same cases; the counter
    gives 2MNK for a known matmul and the kind, group size, result bytes and
    traffic of a known redistribute on a fake 16 x 16 mesh.
(c) ``report.py``: ``pick_hillclimb`` picks as the reference's does, and
    ``main`` over a tree of records prints the table, the picks, the
    rank-local rows and, with no ``--autotune``, the no-artifact line.
"""
import dataclasses
import json
import sys

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro.configs.registry import ASSIGNED
from repro.configs.registry import get_arch as jget_arch
from repro.configs.shapes import SHAPES as JSHAPES
from repro.roofline import analysis as JA
from repro.roofline import hlo as JH
from repro.roofline import report as JR
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.configs.shapes import SHAPES as TSHAPES
from repro_torch.launch import mesh as TMESH
from repro_torch.roofline import analysis as TA
from repro_torch.roofline import hlo as TH
from repro_torch.roofline import report as TR
from repro_torch.sched import profiler as TPROF

RECORD = dict(arch="stablelm-3b", shape="train_4k", mesh="pod16x16",
              compute_s=0.3, memory_s=0.1, collective_s=0.2,
              model_flops=1.2e16, hlo_flops=9.5e13, hlo_bytes=4.2e12,
              collective_bytes=6.5e10, chips=256)


def _dryrun_dict(arch, shape, mesh="pod16x16", ok=True, scale=1.0):
    return {"arch": arch, "shape": shape, "mesh": mesh, "ok": ok,
            "flops": 9.508e13 * scale, "hlo_bytes": 4.228e12 * scale,
            "collective_traffic": 6.511e10 / scale}


# ---------------------------------------------------------------------------
# (a) analysis
# ---------------------------------------------------------------------------

def test_constants_are_the_h100s():
    assert TA.PEAK_FLOPS == TPROF.PEAK_FLOPS_BF16 == 989e12
    assert TA.HBM_BW == TPROF.HBM_BYTES_PER_S == 3.35e12
    assert (TA.ICI_BW, TA.DCN_BW) == (450e9, 50e9)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_model_flops_equal_the_reference(arch):
    for name in sorted(JSHAPES):
        for rank in (8, 16):
            want = JA.model_flops(jget_arch(arch), JSHAPES[name], rank)
            got = TA.model_flops(tget_arch(arch), TSHAPES[name], rank)
            assert got == want, (arch, name, rank)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_ranklocal_savings_equal_the_reference(arch):
    for tokens in (4096, 1000):
        want = JA.ranklocal_savings(jget_arch(arch), JR.RANK_SWEEP, tokens)
        got = TA.ranklocal_savings(tget_arch(arch), TR.RANK_SWEEP, tokens)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.row() == want.row()
        for p in ("flop_saving", "byte_saving", "intensity_true",
                  "intensity_padded"):
            assert getattr(got, p) == getattr(want, p), (arch, p)
    assert TR.RANK_SWEEP == JR.RANK_SWEEP


def test_roofline_properties_equal_the_reference():
    ratio = JA.PEAK_FLOPS / TA.PEAK_FLOPS
    for terms in ((0.3, 0.1, 0.2), (0.1, 0.5, 0.2), (0.1, 0.2, 0.7),
                  (0.0, 0.0, 0.0)):
        rec = dict(RECORD, compute_s=terms[0], memory_s=terms[1],
                   collective_s=terms[2])
        j, t = JA.Roofline(**rec), TA.Roofline(**rec)
        assert t.dominant == j.dominant
        assert t.step_time_lb == j.step_time_lb
        assert t.useful_flops_ratio == j.useful_flops_ratio
        # the one property that reads a constant: the peak
        assert t.mfu_bound == pytest.approx(j.mfu_bound * ratio, rel=1e-15)
        assert t.row()[:-6] == j.row()[:-6]
    assert TA.HEADER == JA.HEADER
    zero = dict(RECORD, hlo_flops=0.0)
    assert TA.Roofline(**zero).useful_flops_ratio == 0.0


@pytest.mark.parametrize("mesh,chips", [("pod16x16", 256),
                                        ("pod2x16x16", 512)])
def test_from_dryrun_equals_the_reference_at_the_h100_constants(mesh, chips):
    d = _dryrun_dict("granite-8b", "prefill_32k", mesh)
    j, t = JA.from_dryrun(d), TA.from_dryrun(d)
    for f in ("arch", "shape", "mesh", "hlo_flops", "hlo_bytes",
              "collective_bytes", "chips", "model_flops"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.chips == chips
    for term, jc, tc in (("compute_s", JA.PEAK_FLOPS, TA.PEAK_FLOPS),
                         ("memory_s", JA.HBM_BW, TA.HBM_BW),
                         ("collective_s", JA.ICI_BW, TA.ICI_BW)):
        assert getattr(t, term) == pytest.approx(
            getattr(j, term) * jc / tc, rel=1e-15), term


def test_load_all_reads_a_tree_of_records(tmp_path):
    recs = [_dryrun_dict("stablelm-3b", "train_4k"),
            _dryrun_dict("stablelm-3b", "decode_32k"),
            _dryrun_dict("rwkv6-3b", "train_4k", ok=False),
            _dryrun_dict("stablelm-3b", "train_4k", "pod2x16x16")]
    for r in recs:
        d = tmp_path / r["mesh"]
        d.mkdir(exist_ok=True)
        (d / f"{r['arch']}__{r['shape']}.json").write_text(json.dumps(r))
    (tmp_path / "pod16x16" / "notes.txt").write_text("not a record")
    (tmp_path / "stray.json").write_text("{}")
    got, want = TA.load_all(str(tmp_path)), JA.load_all(str(tmp_path))
    assert sorted(got) == sorted(want) == [
        "stablelm-3b|decode_32k|pod16x16", "stablelm-3b|train_4k|pod16x16",
        "stablelm-3b|train_4k|pod2x16x16"]
    for k in got:
        assert got[k].hlo_flops == want[k].hlo_flops
        assert got[k].chips == want[k].chips


# ---------------------------------------------------------------------------
# (b) hlo
# ---------------------------------------------------------------------------

CASES = [(kind, rb, g) for kind in JH.COLLECTIVE_KINDS
         for rb in (256, 4096, 12345) for g in (1, 2, 4, 16, 512)]


def test_ring_model_and_summaries_equal_the_reference():
    assert TH.COLLECTIVE_KINDS == JH.COLLECTIVE_KINDS
    jops, tops = [], []
    for i, (kind, rb, g) in enumerate(CASES):
        assert TH._traffic(kind, rb, g) == JH._traffic(kind, rb, g)
        trip = 1.0 + i % 3
        traffic = JH._traffic(kind, rb, g) * trip
        jops.append(JH.CollectiveOp(kind, rb, g, trip, traffic, "x"))
        tops.append(TH.CollectiveOp(kind, rb, g, trip, traffic, "x"))
    assert TH.summarize(tops) == JH.summarize(jops)
    assert TH.total_traffic(tops) == JH.total_traffic(jops)
    # the reference's ring-model cases (tests/test_hlo_parser.py): f32[8,8]
    # over groups of 2
    for kind, mult in (("all-gather", 0.5), ("all-reduce", 1.0),
                       ("reduce-scatter", 0.5), ("all-to-all", 0.5),
                       ("collective-permute", 1.0)):
        assert TH._traffic(kind, 256, 2) == pytest.approx(256 * mult)


def test_counter_counts_a_matmul_and_its_bytes():
    M, N, K = 8, 4, 16
    a, b = torch.randn(M, K), torch.randn(K, N)
    with TH.Counter() as c:
        torch.matmul(a, b)
    got = c.analyze()
    assert got["flops"] == 2 * M * N * K
    assert got["bytes_written"] == M * N * 4
    assert got["collectives"] == {} and got["collective_traffic"] == 0
    with TH.Counter() as c:               # views write nothing
        a.t()
        a.reshape(K, M)
    assert c.bytes_written == 0 and c.flops == 0
    with FakeTensorMode():                # nor do fake tensors need storage
        fa, fb = torch.empty(64, 32), torch.empty(32, 16)
        with TH.Counter() as c:
            fa @ fb
    assert c.flops == 2 * 64 * 16 * 32


def test_counter_reads_a_redistribute_on_a_fake_mesh():
    with TMESH.fake_group(256):
        mesh = TMESH.make_production_mesh(device_type="cpu")
        with FakeTensorMode():
            local = torch.empty(2560 // 16, 6912 // 16, dtype=torch.bfloat16)
            w = DTensor.from_local(local, mesh, (Shard(0), Shard(1)),
                                   run_check=False)
            with TH.Counter() as c:
                out = w.redistribute(mesh, (Replicate(), Shard(1)))
            assert tuple(out.to_local().shape) == (2560, 432)
            g = DTensor.from_local(torch.empty(1000), mesh,
                                   (Replicate(), Partial()), run_check=False)
            with TH.Counter() as c2:
                g.redistribute(mesh, (Replicate(), Replicate()))
    assert not dist.is_initialized()
    (op,) = c.collectives
    rb = 2560 * 432 * 2
    assert (op.kind, op.group_size, op.result_bytes, op.trip_count) == (
        "all-gather", 16, rb, 1.0)
    assert op.traffic_bytes == JH._traffic("all-gather", rb, 16)
    assert c.analyze()["collectives"] == {"all-gather": {
        "count": 1.0, "traffic_bytes": rb * 15 / 16, "result_bytes": rb}}
    (ar,) = c2.collectives
    assert (ar.kind, ar.group_size, ar.result_bytes) == ("all-reduce", 16,
                                                         4000)
    assert ar.traffic_bytes == 2 * 15 / 16 * 4000


# ---------------------------------------------------------------------------
# (c) report
# ---------------------------------------------------------------------------

def _tree(tmp_path):
    for arch in ("stablelm-3b", "granite-8b", "rwkv6-3b"):
        for i, shape in enumerate(("train_4k", "prefill_32k",
                                   "decode_32k")):
            d = tmp_path / "pod16x16"
            d.mkdir(exist_ok=True)
            r = _dryrun_dict(arch, shape, scale=1.0 + len(arch) / 7 + i)
            (d / f"{arch}__{shape}.json").write_text(json.dumps(r))
    return tmp_path


def test_pick_hillclimb_picks_as_the_reference(tmp_path):
    rows = sorted(TA.load_all(str(_tree(tmp_path))).values(),
                  key=lambda r: (r.arch, r.shape))
    assert TR.pick_hillclimb(rows) == JR.pick_hillclimb(rows)


def test_report_main_prints_the_table(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["report", "--dir",
                                      str(_tree(tmp_path))])
    TR.main()
    out = capsys.readouterr().out
    assert out.startswith(TA.HEADER)
    assert "9 combos on pod16x16 (+0 on the other mesh)" in out
    assert "paper-representative" in out and "Rank-local" in out
    assert "no autotune artifact at None" in out
    monkeypatch.setattr(sys, "argv", ["report", "--dir",
                                      str(tmp_path), "--md"])
    TR.main()
    md = capsys.readouterr().out
    assert md.count("| stablelm-3b |") == 4       # 3 roofline + 1 savings
