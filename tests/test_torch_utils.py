"""PyTorch port, the app's host utilities against the JAX package's:
`.sim` config, event logger, metrics sink, gnuplot writer, profiler and
checkpoints (tests/test_aux.py and tests/test_misc.py are the models; the
configuration is the repo's data/models/brain.sim)."""
import dataclasses
import json
import sqlite3
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fembrain_tpu.fem.integrator import FemState as JaxFemState
from fembrain_tpu.utils import checkpoint as jckpt
from fembrain_tpu.utils import logging as jlogging
from fembrain_tpu.utils.config import SimConfig as JaxSimConfig
from fembrain_tpu.utils.metrics import MetricsLogger as JaxMetricsLogger
from fembrain_tpu.utils.metrics import Record as JaxRecord
from fembrain_tpu.utils.plots import write_gnuplot as jax_write_gnuplot

from fembrain_tpu_torch.fem.integrator import FemState
from fembrain_tpu_torch.utils import checkpoint as ckpt
from fembrain_tpu_torch.utils import logging as plogging
from fembrain_tpu_torch.utils import profiler as pprof
from fembrain_tpu_torch.utils.config import SimConfig
from fembrain_tpu_torch.utils.metrics import MetricsLogger, Record
from fembrain_tpu_torch.utils.plots import write_gnuplot

BRAIN_SIM = Path(__file__).resolve().parent.parent / "data/models/brain.sim"


def test_sim_config_loads_brain_sim_as_jax_does(tmp_path):
    """Every field of brain.sim loads the same in both packages; a save
    and load round trip keeps them, and each package reads the other's
    file."""
    cfg = SimConfig.load(BRAIN_SIM)
    ref = JaxSimConfig.load(BRAIN_SIM)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.input_file == "blobtree/brain.blob"
    assert cfg.cellsize == pytest.approx(0.14)
    assert cfg.fixed_vertices == [] and cfg.gravity is False
    assert cfg.force_coeff == 5000.0
    assert (cfg.cam_roll, cfg.cam_tilt, cfg.cam_zoom) == (30.0, 70.0, 8.0)
    assert cfg.resolve_input(BRAIN_SIM) == ref.resolve_input(BRAIN_SIM)
    assert cfg.resolve_input(BRAIN_SIM).is_file()
    cfg.fixed_vertices = [7, 3, 6]
    cfg.save(tmp_path / "p.sim")
    JaxSimConfig.load(tmp_path / "p.sim").save(tmp_path / "j.sim")
    assert (tmp_path / "p.sim").read_text() == (tmp_path / "j.sim").read_text()
    back = SimConfig.load(tmp_path / "j.sim")
    assert dataclasses.asdict(back) == dataclasses.asdict(cfg)


def test_event_logger_matches_jax(tmp_path, capsys):
    """The same lines on screen and in the file sink (timestamps off),
    errors and profile rows on stderr, the events kept; `the_logger` is
    one instance."""
    lines = {}
    for name, mod in (("p", plogging), ("j", jlogging)):
        log = mod.EventLogger(file_path=tmp_path / f"{name}.log",
                              show_timestamp=False, show_source=True)
        log.info("loading blob", source="app")
        log.warning("slow step")
        log.error("no hits", source="render")
        log.log(mod.Severity.PROFILE, "fem 12 ms")
        log.close()
        out = capsys.readouterr()
        lines[name] = (out.out, out.err, (tmp_path / f"{name}.log").read_text(),
                       [(int(s), m) for s, m in log.events])
    assert lines["p"] == lines["j"]
    assert lines["p"][1] == "ERROR render: no hits\nPROFILE: fem 12 ms\n"
    assert [s.name for s in plogging.Severity] == [
        s.name for s in jlogging.Severity]
    assert plogging.the_logger() is plogging.the_logger()


def _records(record_cls):
    return [record_cls(model_name="brain", ct_elements=3480, fps=30.0 + i,
                       ms_anim_total_frame=33.0 - i, cg_iters=200 + i,
                       timestamp="2026-01-01 00:00:0%d" % i)
            for i in range(3)]


def test_metrics_logger_writes_what_jax_writes(tmp_path):
    """The same JSONL and the same sqlite rows as the reference for the
    same records; `last` is the newest record."""
    rows = {}
    for name, logger, rec in (("p", MetricsLogger, Record),
                              ("j", JaxMetricsLogger, JaxRecord)):
        ml = logger(jsonl_path=tmp_path / f"{name}.jsonl",
                    sqlite_path=tmp_path / f"{name}.sqlite")
        for r in _records(rec):
            ml.append(r)
        assert ml.last.fps == 32.0
        ml.close()
        con = sqlite3.connect(tmp_path / f"{name}.sqlite")
        rows[name] = (con.execute("SELECT * FROM experiments").fetchall(),
                      (tmp_path / f"{name}.jsonl").read_text())
        con.close()
    assert rows["p"] == rows["j"]
    assert len(rows["p"][0]) == 3
    assert json.loads(rows["p"][1].splitlines()[2])["fps"] == 32.0
    assert [f.name for f in dataclasses.fields(Record)] == [
        f.name for f in dataclasses.fields(JaxRecord)]


def test_write_gnuplot_matches_jax(tmp_path):
    """From one metrics JSONL, the same .dat and .gp files."""
    ml = MetricsLogger(jsonl_path=tmp_path / "m.jsonl")
    for r in _records(Record) + _records(Record)[:1]:
        ml.append(r)
    ml.close()
    (tmp_path / "p").mkdir()
    gp = write_gnuplot(tmp_path / "m.jsonl", tmp_path / "p" / "perf")
    (tmp_path / "j").mkdir()
    jgp = jax_write_gnuplot(tmp_path / "m.jsonl", tmp_path / "j" / "perf")
    assert gp.read_text() == jgp.read_text() and "plot" in gp.read_text()
    dat = (tmp_path / "p" / "perf.dat").read_text()
    assert dat == (tmp_path / "j" / "perf.dat").read_text()
    assert len(dat.splitlines()) == 5  # header + 4 rows


def test_profiler_events_and_trace(tmp_path):
    """Timing blocks aggregate count/avg/low/high (also for a block that
    raises); the `--xprof` context writes a Chrome trace JSON into its
    directory."""
    prof = pprof.Profiler()
    with prof.event("work"):
        time.sleep(0.01)
    with pytest.raises(ValueError):
        with prof.event("work"):
            raise ValueError
    s = prof.stats()["work"]
    assert s["count"] == 2 and s["high_ms"] >= 9.0 and s["low_ms"] < 9.0
    prof.reset()
    assert prof.stats() == {}
    assert pprof.the_profiler() is pprof.the_profiler()

    x = torch.ones(64, 64)
    with pprof.xprof_trace(tmp_path / "trace"):
        (x @ x).sum()
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())


def _jax_state(q, qvel, dv):
    return JaxFemState(q=jnp.asarray(q), qvel=jnp.asarray(qvel),
                       dv=jnp.asarray(dv))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_cross_between_packages(tmp_path, direction):
    """A FemState saved by one package loads into the other's FemState
    with equal arrays: the same .npz layout (`leaf_i`, `__treedef__`)."""
    rng = np.random.default_rng(7)
    q, qvel, dv = (rng.normal(size=(40, 3)).astype(np.float32)
                   for _ in range(3))
    path = tmp_path / "state.npz"
    if direction == "jax_to_port":
        jckpt.save_pytree(path, _jax_state(q, qvel, dv))
        like = FemState(q=torch.zeros(1), qvel=torch.zeros(1),
                        dv=torch.zeros(1, dtype=torch.float64))
        st = ckpt.load_pytree(path, like)
        got = (st.q.numpy(), st.qvel.numpy(), st.dv.numpy())
        assert st.dv.dtype == torch.float64
    else:
        ckpt.save_pytree(path, FemState(q=torch.tensor(q),
                                        qvel=torch.tensor(qvel),
                                        dv=torch.tensor(dv)))
        st = jckpt.load_pytree(path, _jax_state(q * 0, q * 0, q * 0))
        got = (np.asarray(st.q), np.asarray(st.qvel), np.asarray(st.dv))
    for a, b in zip(got, (q, qvel, dv)):
        np.testing.assert_array_equal(a, b)
    data = np.load(path)
    assert sorted(data.files) == ["__treedef__", "leaf_0", "leaf_1",
                                  "leaf_2"]
    meta = json.loads(data["__treedef__"].tobytes())
    assert meta == {"n": 3, "meta": [{"dtype": "float32", "shape": [40, 3]}
                                     for _ in range(3)]}


def test_checkpoint_of_a_nested_tree_matches_jax(tmp_path):
    """Dicts (sorted keys), tuples, None and scalars flatten in the order
    of jax.tree_util: the same leaves as the JAX package's save, and a
    round trip restores the tree."""
    rng = np.random.default_rng(8)
    a, b = rng.normal(size=(4, 2)), rng.integers(0, 9, size=5)
    tree = {"z": (torch.tensor(a), None), "a": [torch.tensor(b), 3.5],
            "frame": 12}
    jtree = {"z": (jnp.asarray(a), None), "a": [jnp.asarray(b), 3.5],
             "frame": 12}
    ckpt.save_pytree(tmp_path / "p.npz", tree)
    jckpt.save_pytree(tmp_path / "j.npz", jtree)
    p, j = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    assert sorted(p.files) == sorted(j.files)
    for k in p.files:
        if k != "__treedef__":
            np.testing.assert_allclose(p[k], j[k], rtol=1e-6)
    back = ckpt.load_pytree(tmp_path / "p", tree)
    np.testing.assert_array_equal(back["z"][0].numpy(), a)
    assert back["z"][1] is None and back["frame"] == 12
    assert back["a"][1] == 3.5 and back["a"][0].dtype == tree["a"][0].dtype
