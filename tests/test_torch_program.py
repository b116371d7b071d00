"""The port's compiled-program surface against the JAX package's, on the CPU.

* The compile passes (``signature_layout``, ``pack_rules``,
  ``quantize_state``, ``assemble_ledger``) and whole compiles, on the tiny
  classifier and at the paper's full width: the same artifacts and the
  same ledger rows (stage, resource, used, budget, waived), except the
  ``kernel-backend`` row, whose resource differs by design (the H100's
  shared memory per block against the TPU's VMEM).  ``compile_delta``
  gives the same table, spec and rows; waivers and ``BudgetError`` name
  the same stages.
* Program round trips: a program JAX saved loads in the port with
  identical arrays and config; a port program saved and loaded is
  identical; a program the port loaded and saved again loads in JAX, with
  the same leaf names and the manifest's config as it was.
* The deploy surface: ``deploy(DeploySpec())`` builds a ``FlowEngine``; a
  deploy leaves the program's ledger with this deploy's ``int-lowering``
  rows only; sharded and elastic deploys record the ``flow-table-sharding``
  entry; the default compile runs pass 6 (static verification).
* ``swap_tables`` on the float backend, by weights, by a quantized table
  with its spec, by a ruleset and by a ``ProgramDelta``: the next batches
  match JAX's engine after the same swaps (decisions identical, floats
  within rtol 1e-4 / atol 1e-5, ``pred`` where the top-2 margin exceeds
  1e-4: the rules of ``tests/test_torch_flow_engine.py``); the fused engine
  equals the per-round one after every swap; a shape-changing swap raises.
* The numpy ``Checkpointer`` (keep, threaded saves, the tmp-dir rename) and
  the gate, ``repro_torch.compile.gate.main(device="cpu")``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.compile import DataplaneProgram as JProgram
from repro.compile import compile_delta as j_compile_delta
from repro.compile import compile_program as j_compile_program
from repro.compile import passes as jpasses
from repro.compile.ledger import BudgetError as JBudgetError
from repro.configs import get_config
from repro.core import quantization as jq
from repro.core import symbolic as jsym
from repro.core.hardware_model import DEFAULT_DATAPLANE as J_DATAPLANE
from repro.core.state_quant import StateQuantConfig as JStateQuantConfig
from repro.data.pipeline import FlowScenario as JFlowScenario
from repro.data.pipeline import arrival_rounds
from repro.serve.deploy import DeploySpec as JDeploySpec
from repro.serve.flow_engine import FlowEngineConfig as JFlowEngineConfig
from repro.train import classifier as JC
from repro_torch import bridge
from repro_torch.checkpoint import Checkpointer
from repro_torch.compile import (
    BudgetError,
    DataplaneProgram,
    compile_delta,
    compile_program,
    gate,
    passes,
    required_sig_words,
)
from repro_torch.compile.program import _ccfg_from_dict
from repro_torch.core import quantization as tq
from repro_torch.core import symbolic as tsym
from repro_torch.core.hardware_model import DEFAULT_DATAPLANE
from repro_torch.core.state_quant import StateQuantConfig
from repro_torch.data.pipeline import FlowScenario
from repro_torch.serve import flow_engine as TFE
from repro_torch.serve.deploy import DeploySpec, Engine
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import classifier as TC

RTOL, ATOL = 1e-4, 1e-5
PRED_MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _trules(r):
    return bridge.rules_from_numpy(*(np.asarray(a) for a in (r.values, r.masks, r.weights,
                                                             r.hard)), device="cpu")


def _rows(entries, skip_backend=False):
    return [(e.stage, e.resource, e.used, e.budget, e.waived) for e in entries
            if not (skip_backend and e.stage == "kernel-backend")]


def assert_rows_equal(t_entries, j_entries, skip_backend=False):
    t, j = _rows(t_entries, skip_backend), _rows(j_entries, skip_backend)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert a[:2] == b[:2] and a[3:] == b[3:], (a, b)
        assert a[2] == pytest.approx(b[2], abs=1e-6, rel=1e-12), (a, b)


def assert_rules_equal(t, j):
    np.testing.assert_array_equal(t.values.cpu().numpy().view(np.uint32), np.asarray(j.values))
    np.testing.assert_array_equal(t.masks.cpu().numpy().view(np.uint32), np.asarray(j.masks))
    np.testing.assert_array_equal(t.weights.cpu().numpy(), np.asarray(j.weights))
    np.testing.assert_array_equal(t.hard.cpu().numpy(), np.asarray(j.hard))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def assert_params_equal(t, j):
    want = dict(_leaves(_np(j)))
    got = dict(_leaves(t))
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v.cpu().numpy(), want[k], err_msg=str(k))


def _models(tiny_classifier_cfg):
    """(JAX ccfg, JAX params, port ccfg, port params, anomaly signature) at
    the tiny width and at the paper's full width (seed-0 weights)."""
    out = {}
    full = JC.ClassifierConfig(arch=get_config("chimera-dataplane"), n_classes=8,
                               marker_base=256)
    for name, ccfg in (("tiny", tiny_classifier_cfg), ("full", full)):
        params, _ = JC.init_classifier(ccfg, jax.random.PRNGKey(0))
        out[name] = (ccfg, params, bridge.classifier_config_from_reference(ccfg),
                     bridge.params_from_jax(_np(params), device="cpu"))
    return out


@pytest.fixture(scope="module")
def models(tiny_classifier_cfg):
    return _models(tiny_classifier_cfg)


SIG = JFlowScenario(kind="protocol-mix").anomaly_signature
WAIVERS = {"tiny": (), "full": ("state-quantization",)}


def _compile_both(models, width, backend=None, sig=SIG, **kw):
    jccfg, jparams, tccfg, tparams = models[width]
    kw.setdefault("waivers", WAIVERS[width])
    jprog = j_compile_program(jccfg, jparams, rules=lambda c: JC.default_rules(
        c, jnp.asarray(sig)), backend=backend, verify=False, **kw)
    tprog = compile_program(tccfg, tparams, rules=lambda c: TC.default_rules(
        c, sig, device="cpu"), backend=backend, verify=False, **kw)
    return jprog, tprog


# --------------------------------------------------------------------------
# passes, ledger, deltas
# --------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,base", [(512, 256), (1024, 256), (257, 256), (256, 256),
                                        (100, 256)])
def test_required_sig_words_matches_jax(vocab, base):
    assert required_sig_words(vocab, base) == jpasses.required_sig_words(vocab, base)


@pytest.mark.parametrize("width", ["tiny", "full"])
def test_passes_match_jax(models, width):
    jccfg, jparams, tccfg, tparams = models[width]
    spec, tspec = J_DATAPLANE, DEFAULT_DATAPLANE
    assert dataclasses.asdict(spec) == dataclasses.asdict(tspec)
    jccfg2, je = jpasses.signature_layout(jccfg, None, spec)
    tccfg2, te = passes.signature_layout(tccfg, None, tspec)
    assert tccfg2.sig_words == jccfg2.sig_words
    assert_rows_equal(te, je)
    jr = JC.default_rules(jccfg2, jnp.asarray(SIG))
    jr = jsym.RuleSet(values=jr.values[:, :5], masks=jr.masks[:, :5], weights=jr.weights,
                      hard=jr.hard)  # narrower than the layout: packing pads
    jpacked, jtable, jwspec, je = jpasses.pack_rules(jccfg2, jr, spec, 16)
    tpacked, ttable, twspec, te = passes.pack_rules(tccfg2, _trules(jr), tspec, 16)
    assert_rules_equal(tpacked, jpacked)
    np.testing.assert_array_equal(ttable.numpy(), np.asarray(jtable))
    assert (twspec.bits, twspec.scale) == (jwspec.bits, jwspec.scale)
    assert_rows_equal(te, je)
    for horizon in (1, 1024, 100000):
        js, je = jpasses.quantize_state(jccfg2, JStateQuantConfig(), spec, horizon)
        ts, te = passes.quantize_state(tccfg2, StateQuantConfig(), tspec, horizon)
        assert ts == js
        assert_rows_equal(te, je)
    jrep, je = jpasses.assemble_ledger(jccfg2, jpacked, JStateQuantConfig(), 16, 8192, spec)
    trep, te = passes.assemble_ledger(tccfg2, tpacked, StateQuantConfig(), 16, 8192, tspec)
    assert trep.as_dict() == jrep.as_dict() and trep.as_row() == jrep.as_row()
    assert_rows_equal(te, je)
    with pytest.raises(ValueError, match="rules care about bits no packet can set"):
        passes.pack_rules(dataclasses.replace(tccfg2, sig_words=2), tpacked, tspec, 16)


@pytest.mark.parametrize("width,backend", [("tiny", None), ("tiny", "int-emulation"),
                                           ("tiny", "pallas-interpret"), ("full", "xla")])
def test_compile_program_matches_jax(models, width, backend):
    jprog, tprog = _compile_both(models, width, backend)
    assert tprog.ccfg == bridge.classifier_config_from_reference(jprog.ccfg)
    assert tprog.backend == jprog.backend and tprog.tiles is None
    assert_rules_equal(tprog.rules, jprog.rules)
    np.testing.assert_array_equal(tprog.weight_table.numpy(), np.asarray(jprog.weight_table))
    assert tprog.weight_table.dtype == torch.int16
    assert (tprog.s_scale, tprog.horizon) == (jprog.s_scale, jprog.horizon)
    assert_rows_equal(tprog.ledger.entries, jprog.ledger.entries, skip_backend=True)
    assert tprog.ledger.report.as_dict() == jprog.ledger.report.as_dict()
    assert tprog.ledger.stages() == jprog.ledger.stages()
    (row,) = [e for e in tprog.ledger.entries if e.stage == "kernel-backend"]
    assert row.resource == "smem-bytes" and row.budget == 227 * 1024 and row.ok
    if width == "full":
        waived = tprog.ledger.waived()
        assert [e.resource for e in waived] == ["per-flow-sram-bits", "window-sram-bits"]
        assert [e.used for e in waived] == [264192, 131072]


def test_budget_errors_and_waivers_name_the_same_stages(models):
    jccfg, jparams, tccfg, tparams = models["full"]
    with pytest.raises(JBudgetError) as je:
        j_compile_program(jccfg, jparams, verify=False)
    with pytest.raises(BudgetError) as te:
        compile_program(tccfg, tparams, verify=False)
    assert_rows_equal(te.value.ledger.violations(), je.value.ledger.violations())
    assert {e.stage for e in te.value.ledger.violations()} == {"state-quantization"}
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="name no compiler stage") as je:
        j_compile_program(jccfg, jparams, waivers=("nope",), verify=False)
    with pytest.raises(ValueError, match="name no compiler stage") as te:
        compile_program(tccfg, tparams, waivers=("nope",), verify=False)
    assert str(te.value).split(";")[0] == str(je.value).split(";")[0]
    with pytest.raises(ValueError, match="unknown backend 'triton'"):
        compile_program(tccfg, tparams, backend="triton", verify=False)


@pytest.mark.parametrize("kind", ["weights", "ruleset", "bits"])
def test_compile_delta_matches_jax(models, kind):
    jprog, tprog = _compile_both(models, "tiny")
    W = tprog.ccfg.sig_words
    rng = np.random.default_rng(3)
    if kind == "weights":
        w = np.asarray([-2.75], np.float32)
        jd = j_compile_delta(jprog, weights=jnp.asarray(w), step=4)
        td = compile_delta(tprog, weights=torch.from_numpy(w), step=4)
    else:
        vals = rng.integers(0, 2**32, (3, W), dtype=np.uint64).astype(np.uint32)
        jr = jsym.RuleSet(values=jnp.asarray(vals), masks=jnp.asarray(vals),
                          weights=jnp.asarray([0.5, -1.0, 3.0], jnp.float32),
                          hard=jnp.asarray([False, True, False]))
        bits = 8 if kind == "bits" else None
        jd = j_compile_delta(jprog, ruleset=jr, step=5, weight_bits=bits)
        td = compile_delta(tprog, ruleset=_trules(jr), step=5, weight_bits=bits)
        assert_rules_equal(td.ruleset, jd.ruleset)
    assert td.step == jd.step
    assert (td.ruleset is None) == (jd.ruleset is None)
    np.testing.assert_array_equal(td.weight_table.numpy(), np.asarray(jd.weight_table))
    assert (td.weight_spec.bits, td.weight_spec.scale) == (jd.weight_spec.bits,
                                                            jd.weight_spec.scale)
    assert_rows_equal(td.ledger.entries, jd.ledger.entries)


def test_delta_keeps_the_programs_waivers(models):
    jprog, tprog = _compile_both(models, "full")
    jd = j_compile_delta(jprog, weights=jnp.asarray([1.5]))
    td = compile_delta(tprog, weights=torch.tensor([1.5]))
    assert_rows_equal(td.ledger.entries, jd.ledger.entries)
    assert td.ledger.fits() and jd.ledger.fits()
    assert {k: v for k, v in tprog.ledger.diff(td.ledger).items()
            if not k.startswith("kernel-backend")} == {
        k: v for k, v in jprog.ledger.diff(jd.ledger).items()
        if not k.startswith("kernel-backend")}


# --------------------------------------------------------------------------
# program round trips
# --------------------------------------------------------------------------

def _assert_programs_equal(t, j):
    """A port program against a JAX one: arrays, config, metadata, ledger."""
    assert t.ccfg == bridge.classifier_config_from_reference(j.ccfg)
    assert_params_equal(t.params, j.params)
    assert_rules_equal(t.rules, j.rules)
    np.testing.assert_array_equal(t.weight_table.cpu().numpy(), np.asarray(j.weight_table))
    assert (t.weight_spec.bits, t.weight_spec.scale) == (j.weight_spec.bits, j.weight_spec.scale)
    assert dataclasses.asdict(t.state_quant) == dataclasses.asdict(j.state_quant)
    assert (t.s_scale, t.horizon, t.backend, t.tiles) == (j.s_scale, j.horizon, j.backend,
                                                          j.tiles)
    assert dataclasses.asdict(t.spec) == dataclasses.asdict(j.spec)


def _assert_port_programs_equal(a, b):
    assert a.ccfg == b.ccfg
    for (ka, va), (kb, vb) in zip(sorted(_leaves(a.params)), sorted(_leaves(b.params))):
        assert ka == kb and torch.equal(va, vb), ka
    for x, y in zip(a.rules.tensors(), b.rules.tensors()):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert torch.equal(a.weight_table, b.weight_table)
    for f in ("weight_spec", "state_quant", "s_scale", "horizon", "backend", "tiles", "spec"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.ledger.as_dict() == b.ledger.as_dict()


@pytest.mark.parametrize("width,backend", [("tiny", "int-emulation"), ("full", None)])
def test_program_saved_by_jax_loads_in_the_port_and_back(models, tmp_path, width, backend):
    jprog, _ = _compile_both(models, width, backend)
    jprog.save(str(tmp_path / "jax"))
    tprog = DataplaneProgram.load(str(tmp_path / "jax"), device="cpu")
    _assert_programs_equal(tprog, jprog)
    assert tprog.ledger.as_dict() == jprog.ledger.as_dict()
    # saved again by the port: the same leaf names, dtypes and config, and
    # JAX loads it into an identical program
    tprog.save(str(tmp_path / "port"), step=3)
    with open(tmp_path / "jax" / "step_00000000" / "manifest.json") as f:
        man_j = json.load(f)
    with open(tmp_path / "port" / "step_00000003" / "manifest.json") as f:
        man_t = json.load(f)
    for k in ("names", "shapes", "dtypes"):
        assert man_t[k] == man_j[k], k
    assert man_t["extra"] == man_j["extra"]  # the manifest's ccfg kept as it was
    back = JProgram.load(str(tmp_path / "port"))
    assert back.ccfg == jprog.ccfg
    for a, b in zip(jax.tree_util.tree_leaves(back._array_tree()),
                    jax.tree_util.tree_leaves(jprog._array_tree())):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("backend", [None, "int-emulation"])
def test_port_program_round_trips_and_loads_in_jax(models, tmp_path, backend):
    jprog, tprog = _compile_both(models, "tiny", backend)
    tprog.save(str(tmp_path))
    again = DataplaneProgram.load(str(tmp_path), device="cpu")
    _assert_port_programs_equal(again, tprog)
    assert _ccfg_from_dict(again.ccfg_source) == tprog.ccfg
    # the port's own config dict, read by JAX: the JAX package's execution
    # fields (remat, softmax_blk, ...) take its defaults, the rest is equal
    back = JProgram.load(str(tmp_path))
    assert bridge.classifier_config_from_reference(back.ccfg) == tprog.ccfg
    for a, b in zip(jax.tree_util.tree_leaves(back._array_tree()),
                    jax.tree_util.tree_leaves(jprog._array_tree())):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_config_reader_refuses_what_the_port_cannot_honor(models):
    jprog, _ = _compile_both(models, "tiny")
    base = json.loads(json.dumps(dataclasses.asdict(jprog.ccfg)))
    assert _ccfg_from_dict(base) == bridge.classifier_config_from_reference(jprog.ccfg)
    ok = json.loads(json.dumps(base))
    ok["arch"].update(remat="none", scan_layers=False, swa_backend="pallas-tpu")
    ok["arch"]["chimera"].update(use_pallas=True, backend="pallas-tpu")
    assert _ccfg_from_dict(ok) == _ccfg_from_dict(base)
    for path, value, match in ((("arch", "encoder_layers"), 2, "not supported"),
                               (("arch", "chimera", "use_local"), False, "not supported"),
                               (("arch", "chimera", "feature_map", "kind"), "codebook", None),
                               (("arch", "block_pattern"), ["attn", "conv"], "does not have"),
                               (("arch", "novel_field"), 1, "unknown field")):
        bad = json.loads(json.dumps(base))
        node = bad
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value
        if match is None:  # the codebook map crosses, with its size and bits
            node.update(codebook_size=16, codebook_bits=8)
            fm = _ccfg_from_dict(bad).arch.chimera.feature_map
            assert (fm.kind, fm.codebook_size, fm.codebook_bits) == ("codebook", 16, 8)
            continue
        with pytest.raises(ValueError, match=match):
            _ccfg_from_dict(bad)
    # Mamba and xLSTM blocks cross, with the Mamba widths
    hybrid = json.loads(json.dumps(base))
    hybrid["arch"].update(block_pattern=["mamba", "attn"], mamba_d_state=8, mamba_chunk=8)
    arch = _ccfg_from_dict(hybrid).arch
    assert (arch.block_pattern, arch.mamba_d_state, arch.mamba_chunk) == (("mamba", "attn"), 8, 8)
    hybrid["arch"]["block_pattern"] = ["mlstm", "slstm"]
    assert _ccfg_from_dict(hybrid).arch.block_pattern == ("mlstm", "slstm")


# --------------------------------------------------------------------------
# codebook programs cross the packages
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def codebook_models(tiny_classifier_cfg):
    """The tiny classifier with the codebook feature map (16 centroids,
    m 16): fp32 tables, and 8-bit tables quantized per layer with one scale
    each, as ``compile_codebook`` stores them."""
    out = {}
    for bits in (0, 8):
        arch = tiny_classifier_cfg.arch
        arch = dataclasses.replace(arch, chimera=dataclasses.replace(
            arch.chimera, feature_map=dataclasses.replace(
                arch.chimera.feature_map, kind="codebook", m=16, codebook_size=16,
                codebook_bits=bits)))
        jccfg = dataclasses.replace(tiny_classifier_cfg, arch=arch)
        params, _ = JC.init_classifier(jccfg, jax.random.PRNGKey(2))
        if bits:
            fm = params["backbone"]["blocks"]["b0"]["attn"]["chimera"]["fm"]
            qts = [jq.quantize_per_channel(t, bits, axis=None) for t in fm["table"]]
            fm["table"] = jnp.stack([q.values for q in qts])
            fm["table_scale"] = jnp.stack([q.scale for q in qts])
        out[bits] = (jccfg, params, bridge.classifier_config_from_reference(jccfg),
                     bridge.params_from_jax(_np(params), device="cpu"))
    return out


def _replay_decisions(jeng, teng, batches=3, seed=7):
    sc = JFlowScenario(kind="protocol-mix", vocab_size=512, pkt_len=8, packets_per_batch=32,
                       seed=seed)
    for _ in range(batches):
        b = sc.next_batch()
        oj = jeng.ingest(b["flow_ids"], b["tokens"])
        ot = teng.ingest(b["flow_ids"], b["tokens"])
        for k in ("vetoed", "sig", "pred"):
            np.testing.assert_array_equal(np.asarray(ot[k]), np.asarray(oj[k]), err_msg=k)
        for k in FLOATS:
            np.testing.assert_allclose(ot[k], oj[k], rtol=RTOL, atol=ATOL, err_msg=k)
        assert teng.table.slot_of == jeng.table.slot_of


FLOATS = ("trust", "s_nn", "s_sym")


@pytest.mark.parametrize("bits", [0, 8])
def test_codebook_program_crosses_both_ways_with_the_same_decisions(codebook_models, tmp_path,
                                                                    bits):
    jccfg, jparams, tccfg, tparams = codebook_models[bits]
    fcfg = dict(capacity=64, lanes=8)
    rules = dict(rules=lambda c: JC.default_rules(c, jnp.asarray(SIG)))
    jprog = j_compile_program(jccfg, jparams, verify=False, **rules)
    jprog.save(str(tmp_path / "jax"))
    # JAX -> port: the same arrays and config, an integer table kept integer
    loaded = DataplaneProgram.load(str(tmp_path / "jax"), device="cpu")
    _assert_programs_equal(loaded, jprog)
    table = loaded.params["backbone"]["blocks"]["b0"]["attn"]["chimera"]["fm"]["table"]
    assert table.dtype == (torch.int8 if bits else torch.float32)
    map_rows = [e for e in loaded.ledger.entries if e.stage == "resource-ledger"]
    assert_rows_equal(map_rows, [e for e in jprog.ledger.entries
                                 if e.stage == "resource-ledger"])
    _replay_decisions(jprog.deploy(JDeploySpec(flow=JFlowEngineConfig(**fcfg))),
                      loaded.deploy(DeploySpec(flow=TFE.FlowEngineConfig(**fcfg),
                                               device="cpu")))
    # port -> JAX: a program the port compiled, loaded by the JAX package
    tprog = compile_program(tccfg, tparams, verify=False, rules=lambda c: TC.default_rules(
        c, SIG, device="cpu"))
    assert_rows_equal(tprog.ledger.entries, jprog.ledger.entries, skip_backend=True)
    tprog.save(str(tmp_path / "port"))
    back = JProgram.load(str(tmp_path / "port"))
    assert bridge.classifier_config_from_reference(back.ccfg) == tprog.ccfg
    _assert_programs_equal(tprog, back)
    _replay_decisions(back.deploy(JDeploySpec(flow=JFlowEngineConfig(**fcfg))),
                      tprog.deploy(DeploySpec(flow=TFE.FlowEngineConfig(**fcfg), device="cpu")),
                      seed=8)


def test_load_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        DataplaneProgram.load(str(tmp_path), device="cpu")


# --------------------------------------------------------------------------
# the deploy surface
# --------------------------------------------------------------------------

def test_deploy_builds_engines_and_keeps_the_ledger_current(models):
    _, tprog = _compile_both(models, "tiny")
    n0 = len(tprog.ledger.entries)
    fcfg = TFE.FlowEngineConfig(capacity=8, lanes=4)
    eng = tprog.deploy(DeploySpec(flow=fcfg, device="cpu"))
    assert isinstance(eng, TFE.FlowEngine) and isinstance(eng, Engine)
    assert eng.program is tprog and eng.backend == "xla" and eng.fcfg.horizon == tprog.horizon
    assert len(tprog.ledger.entries) == n0
    for _ in range(2):  # int deploys: this deploy's int-lowering rows only
        eng = tprog.deploy(DeploySpec(flow=fcfg, backend="int-emulation", device="cpu"))
        assert eng.backend == "int-emulation"
        rows = [e for e in tprog.ledger.entries if e.stage == "int-lowering"]
        assert len(rows) == 8 and len(tprog.ledger.entries) == n0 + 8
    eng = TFE.FlowEngine.from_program(tprog, fcfg, device="cpu")  # a float deploy again
    assert eng.backend == "xla" and len(tprog.ledger.entries) == n0
    lm = tprog.deploy(DeploySpec(engine="lm", batch_slots=2, max_len=32, device="cpu"))
    assert isinstance(lm, ServeEngine) and isinstance(lm, Engine)
    with pytest.raises(NotImplementedError):
        lm.swap_tables()
    for kind in ("sharded", "elastic"):  # both deploy and record the sharding entry
        eng = tprog.deploy(DeploySpec(engine=kind, num_shards=2, flow=fcfg, device="cpu"))
        assert isinstance(eng, Engine) and eng.num_shards == 2 and eng.program is tprog
        rows = [e for e in tprog.ledger.entries if e.stage == "flow-table-sharding"]
        assert len(rows) == 1 and rows[0].used == eng.shard_state_bytes()
        assert rows[0].detail.startswith("2 shard(s) x 8 flows/shard; aggregate capacity 16")
        assert rows[0].detail.endswith("; elastic") == (kind == "elastic")
        assert (len(tprog.ledger.entries) == n0 + 1 + 1) == (kind == "elastic")  # + a tenant row
    tprog.deploy(DeploySpec(flow=fcfg, device="cpu"))  # a single-engine deploy drops them
    assert len(tprog.ledger.entries) == n0
    with pytest.raises(ValueError, match="single-placement"):
        DeploySpec(engine="flow", num_shards=2)
    with pytest.raises(ValueError, match="unknown engine kind"):
        DeploySpec(engine="ring")
    with pytest.raises(TypeError, match="expects a DeploySpec"):
        tprog.deploy(fcfg)


def test_deploy_defaults_to_the_card(models):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a GPU")
    _, tprog = _compile_both(models, "tiny")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tprog.deploy()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gate.main()


def test_verify_pass_is_not_skipped_silently(models):
    """The default compile runs pass 6: its rows are in the ledger."""
    _, _, tccfg, tparams = models["tiny"]
    rows = [e for e in compile_program(tccfg, tparams).ledger.entries
            if e.stage == "static-verification"]
    assert [e.resource for e in rows] == ["tcam-lint-errors", "tcam-lint-warnings",
                                          "hot-path-host-callbacks", "hot-path-weak-types"]
    assert all(e.ok for e in rows)


def test_gate_runs_on_the_cpu(capsys):
    assert gate.main(device="cpu") == 0
    out = capsys.readouterr().out
    assert "gate ok" in out and "kernel-backend         smem-bytes" in out


# --------------------------------------------------------------------------
# swaps on the float backend
# --------------------------------------------------------------------------

class _Margins:
    """Per-packet top-2 class-logit margins of a per-round port engine."""

    def __init__(self, monkeypatch, engine):
        self.rounds, self.slots = [], None
        real_scores, real_rounds = TC.streaming_scores, engine._ingest_rounds

        def scores(*a, **k):
            out, sticky = real_scores(*a, **k)
            self.rounds.append(out["class_logits"].numpy().copy())
            return out, sticky

        def ingest_rounds(flow_ids, tokens, slots, fresh):
            self.rounds, self.slots = [], slots.copy()
            return real_rounds(flow_ids, tokens, slots, fresh)

        monkeypatch.setattr(TC, "streaming_scores", scores)
        monkeypatch.setattr(engine, "_ingest_rounds", ingest_rounds)

    def get(self, lanes):
        logits = np.empty((len(self.slots), self.rounds[0].shape[1]), np.float32)
        chunks = [r[c0:c0 + lanes] for r in arrival_rounds(self.slots.tolist())
                  for c0 in range(0, len(r), lanes)]
        for chunk, lg in zip(chunks, self.rounds):
            logits[chunk] = lg[: len(chunk)]
        top2 = np.sort(logits, axis=-1)[:, -2:]
        return top2[:, 1] - top2[:, 0]


def _hold(got, want, margins):
    for k in ("vetoed", "sig"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["trust"][got["vetoed"]] == 1.0).all()
    clear = margins > PRED_MARGIN
    np.testing.assert_array_equal(got["pred"][clear], want["pred"][clear])
    for k in ("trust", "s_nn", "s_sym"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_float_swaps_match_jax_and_reach_the_fused_step(models, monkeypatch):
    sc = FlowScenario(kind="rule-violating", vocab_size=512, pkt_len=8, packets_per_batch=32,
                      seed=5)
    jprog, tprog = _compile_both(models, "tiny", sig=sc.anomaly_signature)
    fcfg = dict(capacity=64, lanes=8)
    jeng = jprog.deploy(JDeploySpec(flow=JFlowEngineConfig(**fcfg)))
    teng = tprog.deploy(DeploySpec(flow=TFE.FlowEngineConfig(**fcfg), device="cpu"))
    tfused = tprog.deploy(DeploySpec(flow=TFE.FlowEngineConfig(fused=True, **fcfg),
                                     device="cpu"))
    margins = _Margins(monkeypatch, teng)
    W = tprog.ccfg.sig_words
    jr = jsym.RuleSet(values=jprog.rules.values, masks=jprog.rules.masks,
                      weights=jnp.asarray([2.5], jnp.float32), hard=jnp.asarray([False]))
    hard_other = np.zeros((1, W), np.uint32)
    hard_other[0, 0] = 0b1011  # a hard rule on markers 256, 257 and 259
    jr2 = jsym.RuleSet(values=jnp.asarray(hard_other), masks=jnp.asarray(hard_other),
                       weights=jnp.asarray([0.0], jnp.float32), hard=jnp.asarray([True]))
    table, wspec = jsym.compile_weights_to_table(jnp.asarray([-0.75]), jq.FixedPointSpec(16),
                                                 1 << 20)
    ttable, twspec = tsym.compile_weights_to_table(torch.tensor([-0.75]),
                                                   tq.FixedPointSpec(16), 1 << 20)
    swaps = [
        (dict(weights=jnp.asarray([1.25])), dict(weights=torch.tensor([1.25]))),
        (dict(weights=table, weight_spec=wspec), dict(weights=ttable, weight_spec=twspec)),
        (dict(ruleset=jr), dict(ruleset=_trules(jr))),
        (dict(delta=j_compile_delta(jprog, ruleset=jr2, step=9)),
         dict(delta=compile_delta(tprog, ruleset=_trules(jr2), step=9))),
    ]
    vetoes = []
    for i in range(len(swaps) + 1):
        b = sc.next_batch()
        oj = jeng.ingest(b["flow_ids"], b["tokens"])
        ot = teng.ingest(b["flow_ids"], b["tokens"])
        of = tfused.ingest(b["flow_ids"], b["tokens"])
        mg = margins.get(fcfg["lanes"])
        _hold(ot, oj, mg)
        _hold(of, ot, mg)
        assert teng.table.slot_of == jeng.table.slot_of == tfused.table.slot_of
        vetoes.append(int(ot["vetoed"].sum()))
        if i < len(swaps):
            jkw, tkw = swaps[i]
            jeng.swap_tables(**jkw)
            installed = teng.rules.weights
            for e in (teng, tfused):
                rec = e.swap_tables(**tkw)
                assert rec.source == ("delta" if "delta" in tkw else "manual")
            assert teng.rules.weights is installed  # rewritten in place
            assert_rules_equal(teng.rules, jeng.rules)
            assert_rules_equal(tfused.rules, jeng.rules)
    # the engines own their installed tables: the program's are untouched
    assert tprog.rules.weights.tolist() == [4.0] and tprog.rules.hard.tolist() == [True]
    assert vetoes[0] > 0 and len(teng.swap_history) == len(swaps)


@pytest.mark.parametrize("backend", [None, "int-emulation"])
def test_shape_changing_swap_raises(models, backend):
    _, tprog = _compile_both(models, "tiny", backend)
    eng = tprog.deploy(DeploySpec(flow=TFE.FlowEngineConfig(capacity=8, lanes=4),
                                  device="cpu"))
    W = tprog.ccfg.sig_words
    two = tsym.RuleSet(values=torch.zeros((2, W), dtype=torch.int32),
                       masks=torch.zeros((2, W), dtype=torch.int32),
                       weights=torch.zeros(2), hard=torch.zeros(2, dtype=torch.bool))
    with pytest.raises(ValueError, match="does not match installed"):
        eng.swap_tables(ruleset=two)
    with pytest.raises(ValueError, match="does not match installed"):
        eng.swap_tables(weights=torch.zeros(2))
    with pytest.raises(ValueError, match="not both"):
        eng.swap_tables(weights=torch.zeros(1), delta=compile_delta(tprog, weights=[1.0]))
    assert eng.swap_history == []


def test_swap_records_hold_installs_to_the_control_epoch(models):
    _, tprog = _compile_both(models, "tiny")
    fast = tprog.deploy(DeploySpec(flow=TFE.FlowEngineConfig(capacity=8, lanes=4, t_cp_s=60.0),
                                   device="cpu"))
    rec = fast.swap_tables(weights=torch.tensor([0.5]))
    assert rec.churn_ok and rec.t_cp_s == 60.0 and rec.tick == 0
    slow = tprog.deploy(DeploySpec(flow=TFE.FlowEngineConfig(capacity=8, lanes=4,
                                                             t_cp_s=1e-12), device="cpu"))
    assert not slow.swap_tables(weights=torch.tensor([0.5])).churn_ok


# --------------------------------------------------------------------------
# the checkpointer
# --------------------------------------------------------------------------

def test_checkpointer_keeps_steps_and_writes_atomically(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"b": torch.arange(3), "a": {"z": np.ones((2, 2), np.float32)}}
    for step in (1, 2, 3):
        ck.save(step, tree, extra={"step": step})  # on a writer thread
    ck.wait()
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    got, extra, step = ck.restore()
    assert step == 3 and extra == {"step": 3}
    np.testing.assert_array_equal(got["b"], np.arange(3))
    np.testing.assert_array_equal(got["a"]["z"], np.ones((2, 2), np.float32))
    # JAX's checkpointer reads the same file by position
    jtree, jextra, _ = JCheckpointer(str(tmp_path)).restore(
        {"a": {"z": jnp.zeros((2, 2))}, "b": jnp.zeros(3, jnp.int32)})
    np.testing.assert_array_equal(np.asarray(jtree["b"]), np.arange(3))
    assert ck.manifest()["names"] == ["['a']['z']", "['b']"]
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore()
