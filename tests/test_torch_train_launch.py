"""The port's training launcher and what it binds (``repro_torch/data/
pipeline.py``, ``fault/heartbeat.py``, ``launch/train.py``,
``examples/train_lm.py``) against the reference's, on the CPU: the
pipeline's batches and packing bit for bit, the prefetch order, the
heartbeat monitor on an injected clock, ``run_training`` against the
reference's loop from the reference's initial state (a vlm's patch
embeddings passed in as the reference draws them, ROADMAP C4), a killed
and resumed run bit for bit against an uninterrupted one, the launcher's
flags, and the ``train_lm`` twin at a few steps against the reference
script's lines."""
import dataclasses
import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import to_numpy, torch

from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jpipe
from repro.fault.heartbeat import HeartbeatMonitor as JaxHeartbeatMonitor
from repro.launch import train as jtrain
from repro.train import trainer as jtrainer
from repro_torch.checkpoint.checkpointer import named_leaves
from repro_torch.configs import get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.examples import train_lm
from repro_torch.fault.heartbeat import HeartbeatMonitor
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.train import trainer

NUMBER = re.compile(r"[+-]?\d+(\.\d+)?")


def _masked(text: str) -> str:
    """The printed lines with every number, and the padding around it,
    masked."""
    return re.sub(r"[ \t]+", " ", NUMBER.sub("#", text))


@pytest.mark.parametrize("hosts", [(1, 0), (2, 0), (2, 1)], ids=["one", "host0", "host1"])
def test_batch_at_is_the_references_bit_for_bit(hosts):
    num_hosts, host_id = hosts
    for seed, step in [(0, 0), (0, 12), (7, 3), (123, 999)]:
        jc = jpipe.DataConfig(1000, 16, 8, seed=seed, num_hosts=num_hosts, host_id=host_id)
        tc = tpipe.DataConfig(1000, 16, 8, seed=seed, num_hosts=num_hosts, host_id=host_id)
        want, got = jpipe.batch_at(jc, step), tpipe.batch_at(tc, step)
        for key in ("tokens", "targets"):
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(to_numpy(got[key]), np.asarray(want[key]))
    a = tpipe.batch_at(tpipe.DataConfig(1000, 16, 8, num_hosts=2, host_id=0), 5)
    b = tpipe.batch_at(tpipe.DataConfig(1000, 16, 8, num_hosts=2, host_id=1), 5)
    assert a["tokens"].shape == (4, 16) and not torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["targets"][:, :-1], a["tokens"][:, 1:])


def test_pack_sequences_is_the_references():
    rng = np.random.default_rng(0)
    for lengths, seq in [([3, 5, 2], 4), ([7], 7), ([], 5), ([1, 1, 1, 9], 3)]:
        docs = [rng.integers(1, 50, n).astype(np.int32) for n in lengths]
        np.testing.assert_array_equal(tpipe.pack_sequences(docs, seq),
                                      jpipe.pack_sequences(docs, seq))


def test_prefetch_iterator_order_and_close():
    cfg = tpipe.DataConfig(500, 8, 4, seed=3)
    it = tpipe.PrefetchIterator(cfg, start_step=3)
    for i in range(5):
        got = next(it)
        assert it.step == 3 + i
        assert torch.equal(got["tokens"], tpipe.batch_at(cfg, 3 + i)["tokens"])
    it.close()
    assert not it._thread.is_alive()
    # a batch the producer cannot make is raised in the consumer
    bad = tpipe.PrefetchIterator(tpipe.DataConfig(500, 8, 4, num_hosts=3))
    with pytest.raises(ValueError, match="does not split"):
        next(bad)
    bad.close()
    assert not bad._thread.is_alive()


def test_heartbeat_is_the_references_on_an_injected_clock():
    """The reference's test_heartbeat_detection, and the same beats through
    both monitors."""
    t = [0.0]
    mine = HeartbeatMonitor(4, timeout_s=5.0, clock=lambda: t[0])
    ref = JaxHeartbeatMonitor(4, timeout_s=5.0, clock=lambda: t[0])
    script = [(1.0, [0, 1, 2, 3]), (4.0, [0, 1, 2]), (7.0, [0, 1]), (9.5, [0]),
              (12.0, []), (13.0, [3]), (20.0, [])]
    seen = []
    for now, beats in script:
        t[0] = now
        for w in beats:
            mine.beat(w)
            ref.beat(w)
        got = (mine.dead_workers(), mine.newly_dead(), mine.alive)
        assert got == (ref.dead_workers(), ref.newly_dead(), ref.alive), now
        seen.append(got)
    assert seen[1] == (set(), set(), [0, 1, 2, 3])
    assert seen[2] == ({3}, {3}, [0, 1, 2]) and seen[3][1] == {2}
    assert seen[4] == ({2, 3}, set(), [0, 1])
    assert seen[5] == ({1, 2}, {1}, [0, 3]) and seen[6][1] == {0, 3}


def _reference_frames(cfg, step: int, batch: int) -> np.ndarray:
    """The reference's ``run_training`` patch embeddings of a step."""
    return np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(0), step),
        (batch, cfg.frontend_positions, cfg.d_model), jnp.bfloat16) * 0.02, np.float32)


@pytest.mark.parametrize("arch", ["llama3-8b", "phi-3-vision-4.2b"])
def test_run_training_matches_the_references_loop(arch, capsys, monkeypatch):
    """Four float32 smoke steps of ``run_training`` from the reference's own
    initial state: the losses within 1e-5, the final state within 1e-3 of
    each leaf's scale (four Adam steps turn the rounding of gradients near
    ``eps`` into parts of whole updates), and the printed lines (numbers
    aside)."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    kw = dict(micro_batches=2, learning_rate=1e-2, warmup_steps=1, total_steps=4)
    want = jtrain.run_training(jcfg, jtrainer.TrainSetup(**kw), 4, 4, 16)
    jlines = capsys.readouterr().out
    init = jtrainer.init_train_state(jcfg, jtrainer.TrainSetup(**kw), jax.random.PRNGKey(0))
    frames_fn = None
    if tcfg.family == "vlm":
        frames_fn = lambda step, b: {  # noqa: E731
            "frontend_embeds": torch.from_numpy(_reference_frames(tcfg, step, b))}
    carried = train_state_from_numpy(jax.tree.map(np.asarray, init), "cpu")
    monkeypatch.setattr(ttrain, "init_train_state", lambda *a, **k: carried)
    got = ttrain.run_training(tcfg, trainer.TrainSetup(**kw), 4, 4, 16, device="cpu",
                              frames_fn=frames_fn)
    tlines = capsys.readouterr().out
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for (name, g), w in zip(named_leaves(got["state"]), jax.tree.leaves(want["state"])):
        w = np.asarray(w, np.float64)
        err = np.abs(to_numpy(g.double()) - w).max() if w.size else 0.0
        assert err <= 1e-3 * np.abs(w).max() + 1e-12, (name, err)
    assert _masked(tlines) == _masked(jlines)


@pytest.mark.parametrize("arch", ["llama3-8b", "phi-3-vision-4.2b", "seamless-m4t-medium"])
def test_killed_and_resumed_equals_uninterrupted_bit_for_bit(arch, tmp_path, capsys):
    """bfloat16 smoke configs (a vlm's and an encdec's inputs drawn from
    the step's generator): four steps uninterrupted against two, a kill,
    and a resume from the checkpoint at step 2."""
    cfg = get_config(arch, smoke=True)
    setup = trainer.TrainSetup(micro_batches=2, learning_rate=1e-2, warmup_steps=1,
                               total_steps=4)
    whole = ttrain.run_training(cfg, setup, 4, 4, 16, ckpt_dir=str(tmp_path / "a"),
                                ckpt_every=2, device="cpu")
    first = ttrain.run_training(cfg, setup, 2, 4, 16, ckpt_dir=str(tmp_path / "b"),
                                ckpt_every=2, device="cpu")
    second = ttrain.run_training(cfg, setup, 4, 4, 16, ckpt_dir=str(tmp_path / "b"),
                                 ckpt_every=2, device="cpu")
    assert "resumed from step 2" in capsys.readouterr().out
    assert second["start_step"] == 2 and len(second["losses"]) == 2
    assert first["losses"] + second["losses"] == whole["losses"]
    for (name, a), (_, b) in zip(named_leaves(second["state"]), named_leaves(whole["state"])):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_the_launcher(capsys, tmp_path):
    """Fifty smoke steps saved at step 50 (run_training's default interval),
    then ``--resume`` finds nothing left to run; the refusals."""
    flags = ["--device", "cpu", "--smoke", "--steps", "50", "--batch", "2", "--seq", "8",
             "--ckpt-dir", str(tmp_path)]
    ttrain.main(flags)
    out = capsys.readouterr().out
    assert "step    49" in out and "final loss" in out
    ttrain.main(flags + ["--resume"])
    assert "nothing left to run: the checkpoint is at step 50" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        ttrain.main(["--device", "cpu", "--smoke", "--resume"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.main(["--smoke", "--steps", "1"])


def _reference_example():
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "train_lm.py"
    spec = importlib.util.spec_from_file_location("reference_example_train_lm", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_train_lm_twin_prints_the_references_lines(monkeypatch, capsys):
    """``--tiny`` at 6 steps: the reference script's lines (numbers aside),
    the resume at step 3 restored bit for bit, the loss finite."""
    jex = _reference_example()
    monkeypatch.setattr("sys.argv", ["train_lm.py", "--tiny", "--steps", "6", "--seq", "32"])
    jex.main()
    want = capsys.readouterr().out
    out = train_lm.main(["--tiny", "--steps", "6", "--seq", "32", "--device", "cpu"])
    got = capsys.readouterr().out
    assert _masked(got) == _masked(want)
    assert "resumed from step 3" in got
    assert out["restored_leaves"] == len(named_leaves(out["second"]["state"]))
    assert out["second"]["start_step"] == 3
    assert np.isfinite(out["first"]["losses"] + out["second"]["losses"]).all()
    cfg = train_lm.hundred_m_config(False)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_ff,
            cfg.vocab_size) == (12, 768, 12, 4, 2048, 32768)
