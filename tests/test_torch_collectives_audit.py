"""The port's collective audit (llm_tpu_torch.parallel.collectives_audit):
`classify_groups` against the JAX package's on the same groups, the
result's bytes and table, and `audit_step` over real steps in one gloo
world of 4 ranks on the CPU (tests/torch_parallel_worlds.audit_world):
a TP=4 step moves exactly its reduces and its logits' gather over
`model`, and a DP x TP 2x2 step moves 0 bytes over `data` (the JAX
package's zero-DCN invariant)."""

import numpy as np
import pytest

import torch_parallel_worlds as worlds
from llm_tpu.ggml.types import GgmlType
from llm_tpu.parallel.collectives_audit import (
    classify_groups as j_classify,
)
from llm_tpu_torch.parallel import launch
from llm_tpu_torch.parallel.collectives_audit import (
    AuditResult,
    CollectiveOp,
    audit_step,
    classify_groups,
    note,
)
from llm_tpu_torch.testing import make_tiny_file
from test_torch_archs import one_torch_thread  # noqa: F401 (autouse)

E, V, L, T = 256, 96, 2, 3


class _FakeMesh:
    def __init__(self, shape, names):
        self.devices = np.arange(int(np.prod(shape))).reshape(shape)
        self.axis_names = names


MESH = _FakeMesh((2, 4), ("data", "model"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_audit")
    files = {"llama": str(d / "llama.bin")}
    make_tiny_file("llama", files["llama"], GgmlType.Q4_0, n_embd=E,
                   n_head=4)
    return launch.spawn(worlds.audit_world, 4, "gloo", d / "store",
                        timeout=300, args=(files,))


def test_classify_axes():
    assert classify_groups([[0, 1, 2, 3], [4, 5, 6, 7]], MESH) == "model"
    assert classify_groups([[0, 4], [1, 5]], MESH) == "data"
    assert classify_groups([[0, 5]], MESH) == "mixed"
    assert classify_groups([[2], [6]], MESH) == "replicated"


@pytest.mark.parametrize("groups", [
    [[0, 1]], [[4, 6, 7]], [[1, 5]], [[3, 7], [2, 6]], [[0, 7]], [[5]],
    [[0, 1, 2, 3, 4, 5, 6, 7]]])
def test_classify_matches_reference(groups):
    assert classify_groups(groups, MESH) == j_classify(groups, MESH)


def test_result_bytes_and_table():
    res = AuditResult(ops=[
        CollectiveOp("all-reduce", "model", 100, [[0, 1]], ""),
        CollectiveOp("all-gather", "model", 40, [[0, 1]], ""),
        CollectiveOp("send-recv", "pipe", 7, [[0, 2]], ""),
    ])
    assert res.bytes_by_axis == {"model": 140, "pipe": 7}
    table = res.table().splitlines()
    assert table[1].split() == ["model", "2", "140"]
    assert table[2].split() == ["data", "0", "0"]
    assert table[-1].split() == ["pipe", "1", "7"]


def test_note_outside_audit_is_free():
    note("all-reduce", MESH, [0, 1], 8, "x")
    assert audit_step(lambda: None, MESH).ops == []
    res = audit_step(lambda: note("all-reduce", MESH, [0, 4], 8, "x"), MESH)
    assert [(o.op, o.axis, o.bytes) for o in res.ops] == [
        ("all-reduce", "data", 8)]


def _expected(B, model):
    """One step of B streams at T tokens: a reduce after wo and after down
    in each layer ([B*T, E] f32), and the logits' gather ([B*T, V] f32)."""
    reduce = B * T * E * 4
    return {"all-reduce": [reduce] * (2 * L), "all-gather": [B * T * V * 4]}


@pytest.mark.parametrize("name,B,model", [("tp", 2, 4), ("dp_tp", 2, 2)])
def test_step_bytes_exact(world, name, B, model):
    for rank, out in enumerate(world):
        by_axis, ops, table = out[name]
        want = _expected(B, model)
        got = {}
        for op, axis, nbytes, groups in ops:
            assert axis == "model"
            row = rank // model * model
            assert groups == [list(range(row, row + model))]
            got.setdefault(op, []).append(nbytes)
        assert got == want
        assert by_axis == {"model": sum(sum(v) for v in want.values())}
        assert by_axis.get("data", 0) == 0
        assert "model" in table


def test_dp_tp_forward_zero_bytes_on_data(world):
    for out in world:
        by_axis, _, table = out["dp_tp"]
        assert by_axis.get("data", 0) == 0 and by_axis.get("mixed", 0) == 0
        assert table.splitlines()[2].split() == ["data", "0", "0"]
