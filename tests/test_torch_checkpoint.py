"""The port's checkpoint/resume (``accl_tpu_torch/utils/checkpoint.py``)
against the reference's contract (``tests/test_checkpoint.py``), on the
CPU.

The reference's tests, case for case, on ``torch.save`` checkpoints in
place of orbax's; the integrity manifests of both packages compared JSON
for JSON, and their verifiers error for error; a resumed tiny Llama held
bitwise to the unbroken run.
"""

from __future__ import annotations

import json
import os
import shutil
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from accl_tpu.constants import ACCLError as RefACCLError  # noqa: E402
from accl_tpu.utils import checkpoint as RC  # noqa: E402
from accl_tpu_torch.constants import ACCLError, ErrorCode  # noqa: E402
from accl_tpu_torch.models import Llama, LlamaConfig  # noqa: E402
from accl_tpu_torch.utils import (CheckpointManager,  # noqa: E402
                                  load_checkpoint, save_checkpoint)
from accl_tpu_torch.utils import checkpoint as PC  # noqa: E402

TEST_LIMIT_S = 120


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test fails once it runs past TEST_LIMIT_S seconds."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past its {TEST_LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _largest_payload_file(root):
    best, best_size = None, -1
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            s = os.path.getsize(p)
            if s > best_size:
                best, best_size = p, s
    return best


def _flip(path, bit: int = 0x01):
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= bit
    open(path, "wb").write(bytes(data))


def _assert_integrity_error(exc):
    assert exc.error_word & int(ErrorCode.DATA_INTEGRITY_ERROR)


# -- the reference's tests -----------------------------------------------------

def test_one_shot_roundtrip(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones(5, dtype=torch.bfloat16)},
            "step": torch.tensor(7)}
    save_checkpoint(str(tmp_path / "ck"), tree)
    out = load_checkpoint(str(tmp_path / "ck"), target=tree)
    assert torch.equal(out["w"], tree["w"])
    assert out["nested"]["b"].dtype == torch.bfloat16
    assert int(out["step"]) == 7
    # a target leaf's dtype rules; no target: the tree as saved
    f64 = load_checkpoint(str(tmp_path / "ck"), target=dict(
        tree, w=torch.zeros(3, 4, dtype=torch.float64)))
    assert f64["w"].dtype == torch.float64
    assert torch.equal(f64["w"], tree["w"].double())
    assert torch.equal(load_checkpoint(str(tmp_path / "ck"))["w"], tree["w"])
    assert sorted(os.listdir(tmp_path)) == ["ck", "ck.integrity.json"]
    assert os.listdir(tmp_path / "ck") == ["state.pt"]


def test_manager_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "run"), max_to_keep=2)
    tree = {"w": torch.zeros(4)}
    for step in (1, 2, 3):
        mgr.save(step, {"w": torch.full((4,), float(step))})
    assert mgr.latest_step() == 3
    out = mgr.restore(target=tree)
    assert float(out["w"][0]) == 3.0
    with pytest.raises(FileNotFoundError):       # retention evicted step 1
        mgr.restore(step=1, target=tree)
    assert sorted(os.listdir(tmp_path / "run")) == [".integrity", "2", "3"]
    mgr.close()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_bit_rot_detected_at_load(tmp_path):
    tree = {"w": torch.arange(64.0), "step": torch.tensor(3)}
    path = str(tmp_path / "ck")
    save_checkpoint(path, tree)
    _flip(_largest_payload_file(path))
    with pytest.raises(ACCLError) as ei:
        load_checkpoint(path, target=tree)
    _assert_integrity_error(ei.value)
    assert "crc32" in str(ei.value) and "(bit rot)" in str(ei.value)


def test_truncation_and_torn_checkpoint_detected(tmp_path):
    tree = {"w": torch.arange(64.0)}
    path = str(tmp_path / "ck")
    save_checkpoint(path, tree)
    victim = _largest_payload_file(path)
    raw = open(victim, "rb").read()
    open(victim, "wb").write(raw[:-1])
    with pytest.raises(ACCLError) as ei:
        load_checkpoint(path, target=tree)
    _assert_integrity_error(ei.value)
    assert "(truncated)" in str(ei.value)
    os.remove(victim)
    with pytest.raises(ACCLError) as ei:
        load_checkpoint(path, target=tree)
    _assert_integrity_error(ei.value)
    assert "(torn checkpoint)" in str(ei.value)


def test_legacy_checkpoint_without_manifest_still_loads(tmp_path):
    tree = {"w": torch.arange(8.0)}
    path = str(tmp_path / "ck")
    save_checkpoint(path, tree)
    os.remove(path + ".integrity.json")
    out = load_checkpoint(path, target=tree)
    assert torch.equal(out["w"], tree["w"])


def test_manager_verifies_step_and_prunes_manifests(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "run"), max_to_keep=2)
    tree = {"w": torch.zeros(16)}
    for step in (1, 2, 3):
        mgr.save(step, {"w": torch.full((16,), float(step))})
    mdir = tmp_path / "run" / ".integrity"
    assert sorted(p.name for p in mdir.iterdir()) == ["2.json", "3.json"]
    _flip(_largest_payload_file(str(tmp_path / "run" / "3")), 0x40)
    with pytest.raises(ACCLError) as ei:
        mgr.restore(step=3, target=tree)
    _assert_integrity_error(ei.value)
    out = mgr.restore(step=2, target=tree)
    assert float(out["w"][0]) == 2.0
    mgr.close()


def test_state_resume_identical(tmp_path):
    """The reference's resume test on one device: 4 Adam steps; a
    checkpoint at step 2 restored into fresh state reproduces steps 3-4
    bitwise."""
    w0 = torch.arange(16.0).reshape(4, 4)
    xs = [torch.from_numpy(np.random.default_rng(i).standard_normal(4)
                           .astype(np.float32)) for i in range(4)]

    def run(w, opt, batch):
        for x in batch:
            opt.zero_grad()
            torch.sum((w @ x) ** 2).backward()
            opt.step()

    w = w0.clone().requires_grad_(True)
    run(w, torch.optim.Adam([w], lr=1e-1), xs)
    golden = w.detach().clone()

    w = w0.clone().requires_grad_(True)
    opt = torch.optim.Adam([w], lr=1e-1)
    run(w, opt, xs[:2])
    mgr = CheckpointManager(str(tmp_path / "resume"))
    mgr.save(2, {"w": w.detach(), "opt": opt.state_dict()})
    restored = mgr.restore()
    w2 = restored["w"].clone().requires_grad_(True)
    opt2 = torch.optim.Adam([w2], lr=1e-1)
    opt2.load_state_dict(restored["opt"])
    run(w2, opt2, xs[2:])
    assert torch.equal(w2.detach(), golden)
    mgr.close()


def test_manager_save_wait_false_warns(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "warn"))
    with pytest.warns(RuntimeWarning, match="wait=False"):
        mgr.save(0, {"w": torch.zeros(4)}, wait=False)
    out = mgr.restore(0, target={"w": torch.zeros(4)})
    assert torch.equal(out["w"], torch.zeros(4))
    mgr.close()


# -- against the reference's manifests -----------------------------------------

def _ckpt_tree(root):
    """A directory of files at several sizes, one in a subdirectory."""
    rng = np.random.default_rng(7)
    os.makedirs(os.path.join(root, "d", "e"))
    for rel, n in (("a.bin", 0), ("b.bin", 1), ("d/c.bin", 3 << 20),
                   ("d/e/f.bin", (1 << 20) + 5)):
        with open(os.path.join(root, rel), "wb") as f:
            f.write(rng.integers(0, 256, n, dtype=np.uint8).tobytes())


def test_manifest_json_equals_the_reference(tmp_path):
    root = str(tmp_path / "ck")
    _ckpt_tree(root)
    want = RC.write_integrity_manifest(root, str(tmp_path / "ref.json"))
    got = PC.write_integrity_manifest(root, str(tmp_path / "port.json"))
    assert got == want
    assert (open(tmp_path / "port.json").read()
            == open(tmp_path / "ref.json").read())
    assert set(json.load(open(tmp_path / "port.json"))) == {"version",
                                                            "files"}
    # a step manifest's and a one-shot manifest's paths
    mgr = CheckpointManager(str(tmp_path / "run"))
    assert mgr._manifest_path(5) == str(tmp_path / "run" / ".integrity"
                                        / "5.json")
    assert PC._oneshot_manifest_path(str(tmp_path / "x") + "/") == \
        RC._oneshot_manifest_path(str(tmp_path / "x"))


def _corrupt(kind, root, manifest):
    if kind == "bit rot":
        _flip(os.path.join(root, "d/c.bin"), 0x10)
    elif kind == "truncated":
        p = os.path.join(root, "d/e/f.bin")
        open(p, "r+b").truncate(os.path.getsize(p) - 2)
    elif kind == "torn":
        os.remove(os.path.join(root, "b.bin"))
    elif kind == "manifest":
        open(manifest, "w").write("{\"version\": 1")
    elif kind == "no files key":
        open(manifest, "w").write("{\"version\": 1}")


@pytest.mark.parametrize("kind", ["bit rot", "truncated", "torn",
                                  "manifest", "no files key"])
def test_verifier_errors_equal_the_reference(tmp_path, kind):
    """The same corruption: both verifiers raise DATA_INTEGRITY_ERROR with
    the same message; intact, neither raises."""
    root = str(tmp_path / "ck")
    _ckpt_tree(root)
    manifest = str(tmp_path / "m.json")
    RC.write_integrity_manifest(root, manifest)
    RC.verify_integrity_manifest(root, manifest)
    PC.verify_integrity_manifest(root, manifest)
    _corrupt(kind, root, manifest)
    with pytest.raises(RefACCLError) as want:
        RC.verify_integrity_manifest(root, manifest)
    with pytest.raises(ACCLError) as got:
        PC.verify_integrity_manifest(root, manifest)
    assert got.value.error_word == want.value.error_word == int(
        ErrorCode.DATA_INTEGRITY_ERROR)
    assert str(got.value) == str(want.value)


def test_torn_save_keeps_the_good_checkpoint(tmp_path, monkeypatch):
    """A save that fails while writing leaves the previous checkpoint and
    no temporary directory behind."""
    path = str(tmp_path / "ck")
    save_checkpoint(path, {"w": torch.ones(8)})

    def broken(obj, f):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(PC.torch, "save", broken)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(path, {"w": torch.zeros(8)})
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path)) == ["ck", "ck.integrity.json"]
    assert torch.equal(load_checkpoint(path)["w"], torch.ones(8))
    save_checkpoint(path, {"w": torch.zeros(8)})   # a save over it
    assert torch.equal(load_checkpoint(path)["w"], torch.zeros(8))
    assert sorted(os.listdir(tmp_path)) == ["ck", "ck.integrity.json"]


@pytest.mark.parametrize("cut", ["tree", "manifest"])
def test_save_cut_between_renames_never_loads_unchecked(tmp_path,
                                                        monkeypatch, cut):
    """A save over a checkpoint, cut at the rename of its tree or of its
    manifest: cut before the tree's, the old checkpoint still verifies
    and loads; cut between the two, the new tree is refused by the old
    manifest. Either way the path holds a whole tree, and the next save
    clears what the cut one left (its temporaries, a leftover directory
    of a process killed mid-save) and stands verified."""
    path = str(tmp_path / "ck")
    save_checkpoint(path, {"w": torch.ones(8)})
    real = os.replace

    def cut_at(src, dst):
        tree = dst.endswith(os.path.join("ck", "state.pt"))
        if (cut == "tree" and tree) or (cut == "manifest"
                                        and dst.endswith(".integrity.json")):
            raise OSError(f"cut at the {cut}")
        real(src, dst)

    monkeypatch.setattr(PC.os, "replace", cut_at)
    with pytest.raises(OSError, match=f"cut at the {cut}"):
        save_checkpoint(path, {"w": torch.zeros(8)})
    monkeypatch.undo()
    assert os.path.isfile(os.path.join(path, "state.pt"))
    if cut == "tree":
        PC.verify_integrity_manifest(path, path + ".integrity.json")
        assert torch.equal(load_checkpoint(path)["w"], torch.ones(8))
    else:
        with pytest.raises(ACCLError) as e:
            load_checkpoint(path)
        _assert_integrity_error(e.value)
        assert "(bit rot)" in str(e.value)
    os.makedirs(tmp_path / "ck.tmp-killed")
    save_checkpoint(path, {"w": torch.full((8,), 2.0)})
    assert sorted(os.listdir(tmp_path)) == ["ck", "ck.integrity.json"]
    assert torch.equal(load_checkpoint(path)["w"], torch.full((8,), 2.0))


# -- resume of the tiny Llama ----------------------------------------------------

def test_llama_resume_equals_the_unbroken_run(tmp_path):
    """Tiny Llama, Adam, CPU: three unbroken steps against one step, a
    save, a restore into a fresh model and optimizer (another seed) and
    two more steps; every parameter and loss bitwise."""
    cfg = LlamaConfig.tiny()
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 32)))

    def fresh(seed):
        m = Llama(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
        opt = torch.optim.Adam(m.parameters(), lr=1e-2)
        return m, opt, m.make_train_step(opt)

    m, _, step = fresh(0)
    unbroken = [step(tokens) for _ in range(3)]
    want = {n: p.detach().clone() for n, p in m.named_parameters()}

    m, opt, step = fresh(0)
    losses = [step(tokens)]
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save(1, {"params": m.state_dict(), "opt_state": opt.state_dict(),
                 "step": 1})
    saved = {n: p.detach().clone() for n, p in m.state_dict().items()}
    m2, opt2, step2 = fresh(1)
    assert not torch.equal(m2.embed, m.embed)
    restored = mgr.restore(target={"params": m2.state_dict(),
                                   "opt_state": opt.state_dict(),
                                   "step": 0})
    assert restored["step"] == 1
    m2.load_state_dict(restored["params"])
    opt2.load_state_dict(restored["opt_state"])
    for n, t in m2.state_dict().items():
        assert torch.equal(t, saved[n]), n
    losses += [step2(tokens) for _ in range(2)]
    assert [float(x) for x in losses] == [float(x) for x in unbroken]
    for n, p in m2.named_parameters():
        assert torch.equal(p.detach(), want[n]), n
    shutil.rmtree(tmp_path / "run")
