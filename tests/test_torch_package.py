"""Guards of the PyTorch port's package boundary.

* ``src/repro_torch`` (every package, ``launch/`` included) and
  ``chip_smoke.py`` import neither jax nor the JAX package (the card's
  machine has no jax), and the port's data fixtures are its own copies;
* the port's own copy of the traffic generator emits the JAX package's
  batches, packet for packet;
* without a GPU the engine and the kernels refuse to run (no CPU fallback
  for a CUDA request, no build without nvcc);
* the bridge converts every leaf of the JAX classifier parameters into the
  port's layout.
"""

import ast
import dataclasses
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.train import classifier as JC
from repro_torch import bridge
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import _build
from repro_torch.kernels.decode_step import ops as dops
from repro_torch.kernels.flow_ingest import ops as sops
from repro_torch.serve.flow_engine import FlowEngine, FlowEngineConfig
from repro_torch.train import classifier as TC

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path.name}:{node.lineno} imports {name}"


def test_guard_walks_every_port_package():
    """The walk above covers every package of the port, ``launch/`` and
    ``data/`` included, and every one of them is covered."""
    walked = set(_port_files())
    pkg_root = ROOT / "src" / "repro_torch"
    for pkg in ("launch", "data", "serve", "core", "compile", "kernels", "runtime", "analysis"):
        assert (pkg_root / pkg / "__init__.py") in walked, pkg
    for mod in ("launch/flow_serve.py", "data/traces.py", "data/campaigns.py",
                "serve/adaptive_loop.py", "serve/redteam.py", "core/two_timescale.py",
                "runtime/fault_tolerance.py", "serve/sharded_flow_engine.py",
                "serve/elastic.py", "models/mamba.py", "models/xlstm.py",
                "configs/jamba_15_large.py", "configs/xlstm_125m.py",
                "analysis/graph_lint.py", "analysis/intervals.py", "analysis/tcam_lint.py",
                "analysis/retrace_sentry.py", "analysis/verify.py", "analysis/gate.py",
                "core/state_quant.py"):
        assert (pkg_root / mod) in walked, mod


def test_port_data_fixtures_are_its_own_copies():
    """The port reads its own data files (``data/fixtures/``), byte copies of
    the JAX package's, and holds no code there."""
    from repro_torch.data import traces

    fixtures = ROOT / "src" / "repro_torch" / "data" / "fixtures"
    assert Path(traces.SAMPLE_TRACE).parent == fixtures
    files = sorted(fixtures.iterdir())
    assert [f.name for f in files] == ["sample_trace.json"]
    for f in files:
        assert f.read_bytes() == (ROOT / "src" / "repro" / "data" / "fixtures" / f.name).read_bytes()


@pytest.mark.parametrize("kind", ["protocol-mix", "port-scan", "burst", "rule-violating", "mix"])
@pytest.mark.parametrize("seed", [0, 7])
def test_flow_scenario_copy_matches_reference(kind, seed):
    kw = dict(kind=kind, pkt_len=8, packets_per_batch=64, seed=seed, vocab_size=1024)
    a, b = jpipe.FlowScenario(**kw), tpipe.FlowScenario(**kw)
    for _ in range(5):
        ba, bb = a.next_batch(), b.next_batch()
        assert ba.keys() == bb.keys()
        for k in ba:
            np.testing.assert_array_equal(ba[k], bb[k])
            assert ba[k].dtype == bb[k].dtype
        assert jpipe.arrival_rounds(ba["flow_ids"].tolist()) == tpipe.arrival_rounds(
            bb["flow_ids"].tolist()
        )
    np.testing.assert_array_equal(a.anomaly_signature, b.anomaly_signature)
    assert tpipe.SCENARIO_KINDS == jpipe.SCENARIO_KINDS


def test_sharded_flow_scenario_copy_matches_reference():
    kw = dict(kind="heavy-churn", pkt_len=4, packets_per_batch=48, seed=3, num_shards=3)
    for shard in range(3):
        a = jpipe.FlowScenario(shard_id=shard, **kw)
        b = tpipe.FlowScenario(shard_id=shard, **kw)
        for _ in range(3):
            np.testing.assert_array_equal(a.next_batch()["flow_ids"], b.next_batch()["flow_ids"])


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a GPU")


@pytest.fixture(scope="module")
def tiny_pair(tiny_classifier_cfg):
    params, _ = JC.init_classifier(tiny_classifier_cfg, jax.random.PRNGKey(0))
    return params, bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                          device="cpu")


def test_engine_without_device_raises_on_a_host_without_gpu(no_gpu, tiny_classifier_cfg,
                                                            tiny_pair):
    ccfg = bridge.classifier_config_from_reference(tiny_classifier_cfg)
    rules = TC.default_rules(ccfg, [300, 301, 302, 303], device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FlowEngine(ccfg, tiny_pair[1], rules, FlowEngineConfig(capacity=4, lanes=2))
    FlowEngine(ccfg, tiny_pair[1], rules, FlowEngineConfig(capacity=4, lanes=2), device="cpu")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    real_isfile = os.path.isfile
    monkeypatch.setattr(os.path, "isfile",
                        lambda p: False if str(p).endswith("nvcc") else real_isfile(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())


def test_kernel_library_hash_covers_sources_and_headers(tmp_path):
    """An edit to a header the sources include names another library, so
    a stale build is never loaded."""
    assert (_build.CSRC / "split_fp32.cuh").exists()
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _build.source_hash(tmp_path)
    assert _build.source_hash(tmp_path) == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.source_hash(tmp_path) != first
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build.source_hash(tmp_path) not in (first,)


def test_wrappers_refuse_devices_without_a_kernel():
    """Only CPU tensors take the plain version; others launch or raise."""
    meta = torch.device("meta")
    BH, d, L, m = 4, 8, 4, 8
    z = lambda *s: torch.zeros(s, device=meta)  # noqa: E731
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        dops.decode_step(z(BH, 1, d), z(BH, d), z(BH, d), z(BH, 1, m), z(BH, L, m),
                         z(BH, L, d), z(BH, L, d), z(BH, m, d), z(BH, m),
                         torch.zeros((2,), dtype=torch.int32, device=meta), chunk_size=L)
    rules = TC.default_rules(TC.ClassifierConfig(arch=None, sig_words=1), [256], device=meta)
    params = {"cls": {"w": z(d, 3)}, "anom": {"w": z(d, 1)},
              "fusion": {"alpha": torch.zeros((), device=meta),
                         "beta": torch.zeros((), device=meta)}}
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        sops.flow_score(params, rules, z(5, d),
                        torch.zeros((5, 1), dtype=torch.int32, device=meta),
                        torch.zeros((5,), dtype=torch.bool, device=meta))
    assert dops.launches == 0 and sops.launches == 0


def test_wrappers_check_shapes_and_types():
    BH, d, L, m = 4, 8, 4, 8
    z = lambda *s: torch.zeros(s)  # noqa: E731
    c = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="S has shape"):
        dops.decode_step(z(BH, 1, d), z(BH, d), z(BH, d), z(BH, 1, m), z(BH, L, m),
                         z(BH, L, d), z(BH, L, d), z(BH, m + 1, d), z(BH, m), c, chunk_size=L)
    with pytest.raises(TypeError, match="count must be int32"):
        dops.decode_step(z(BH, 1, d), z(BH, d), z(BH, d), z(BH, 1, m), z(BH, L, m),
                         z(BH, L, d), z(BH, L, d), z(BH, m, d), z(BH, m), c.long(),
                         chunk_size=L)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def test_bridge_round_trips_every_leaf(tiny_classifier_cfg, tiny_pair):
    params, tparams = tiny_pair
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, params)))
    got = dict(_leaves(tparams))
    assert got.keys() == want.keys()  # no leaf dropped, none invented
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=str(path))
    # the port's own initializer builds exactly this layout
    own = TC.init_classifier(bridge.classifier_config_from_reference(tiny_classifier_cfg),
                             torch.Generator().manual_seed(0), device="cpu")
    assert {p: tuple(t.shape) for p, t in _leaves(own)} == {
        p: tuple(t.shape) for p, t in got.items()
    }
    with pytest.raises(TypeError):
        bridge.params_from_jax({"w": [1.0, 2.0]}, device="cpu")


def test_bridge_rules_round_trip(tiny_classifier_cfg):
    jr = JC.default_rules(tiny_classifier_cfg, jax.numpy.asarray([300, 400, 511, 287]))
    arrays = [np.asarray(a) for a in (jr.values, jr.masks, jr.weights, jr.hard)]
    tr = bridge.rules_from_numpy(*arrays, device="cpu")
    np.testing.assert_array_equal(tr.values.numpy().view(np.uint32), arrays[0])
    np.testing.assert_array_equal(tr.masks.numpy().view(np.uint32), arrays[1])
    assert tr.values.dtype == torch.int32 and tr.hard.dtype == torch.bool
    arch = bridge.arch_from_reference(tiny_classifier_cfg.arch)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "padded_vocab"):
        assert getattr(arch, f) == getattr(tiny_classifier_cfg.arch, f)
    assert dataclasses.asdict(arch.chimera)["n_global"] == tiny_classifier_cfg.arch.chimera.n_global
