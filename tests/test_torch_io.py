"""URI workdirs in the port: ``utils/io.py`` and the pipelines through it.

The port's counterpart of tests/test_io_pipeline.py: a ``myfs://`` scheme
registered onto a temporary directory (``LocalMirrorHandler``), the helpers
on scheme paths, and ``main`` train -> resume -> eval -> sample on a
``myfs://`` workdir at tiny width, every artifact under the mirror root and
nothing under a local ``myfs:`` directory. A scheme without a handler
raises (the JAX package sends it to ``tf.io.gfile``, which the port never
imports), and a handler without local paths takes checkpoints through
``open_file``.
"""
import glob
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from score_sde_pytorch_tpu_torch import checkpoint, configs, losses, main
from score_sde_pytorch_tpu_torch.models import utils as mutils
from score_sde_pytorch_tpu_torch.utils import image
from score_sde_pytorch_tpu_torch.utils import io as io_utils
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

FLAGSHIP = str(Path(__file__).resolve().parents[1]
               / "score_sde_pytorch_tpu_torch" / "configs" / "ve"
               / "cifar10_ncsnpp_continuous.py")
TINY = ["--config.model.nf=16", "--config.model.ch_mult=(1,2)",
        "--config.model.num_res_blocks=1",
        "--config.model.attn_resolutions=(8,)",
        "--config.data.image_size=16", "--config.model.num_scales=2"]
TRAIN = ["--mode", "train", "--device", "cpu",
         "--config.training.batch_size=4",
         "--config.training.n_jitted_steps=1", "--config.training.log_freq=1",
         "--config.training.eval_freq=2", "--config.training.snapshot_freq=2",
         "--config.training.snapshot_freq_for_preemption=2"]


@pytest.fixture
def myfs(tmp_path, monkeypatch):
  """``myfs://`` mirrored onto ``tmp_path/bucket_root``; the working
  directory is ``tmp_path/cwd``, where no ``myfs:`` may appear."""
  root = tmp_path / "bucket_root"
  root.mkdir()
  cwd = tmp_path / "cwd"
  cwd.mkdir()
  monkeypatch.chdir(cwd)
  io_utils.register_scheme("myfs", io_utils.LocalMirrorHandler("myfs",
                                                               str(root)))
  yield root
  io_utils.unregister_scheme("myfs")
  assert os.listdir(cwd) == [], os.listdir(cwd)


def test_io_helpers_on_scheme_paths(myfs):
  io_utils.makedirs("myfs://bucket/a/b")
  assert io_utils.exists("myfs://bucket/a/b")
  assert os.path.isdir(os.path.join(myfs, "bucket/a/b"))
  io_utils.save_npz("myfs://bucket/a/x.npz", v=np.arange(3))
  assert io_utils.load_npz("myfs://bucket/a/x.npz")["v"].tolist() == [0, 1, 2]
  io_utils.save_npy("myfs://bucket/a/y.np", np.ones(2))
  assert io_utils.exists("myfs://bucket/a/y.np.npy")
  assert sorted(io_utils.listdir("myfs://bucket/a")) == ["b", "x.npz",
                                                         "y.np.npy"]
  assert io_utils.localize("myfs://bucket/a") == os.path.join(myfs,
                                                              "bucket/a")
  with io_utils.open_file("myfs://bucket/c/d.txt", "w") as f:
    f.write("written")
  assert (myfs / "bucket/c/d.txt").read_text() == "written"
  image.save_image(np.zeros((4, 4, 3)), "myfs://bucket/c/e.png")
  assert (myfs / "bucket/c/e.png").read_bytes()[:4] == b"\x89PNG"


def test_plain_paths_use_the_standard_library(tmp_path):
  path = str(tmp_path / "x.npz")
  io_utils.save_npz(path, v=np.arange(2))
  assert io_utils.load_npz(path)["v"].tolist() == [0, 1]
  assert io_utils.localize(path) == path
  assert io_utils._handler(path) is None


@pytest.mark.parametrize("call", [
    lambda p: io_utils.makedirs(p), lambda p: io_utils.open_file(p, "wb"),
    lambda p: io_utils.exists(p), lambda p: io_utils.listdir(p),
    lambda p: io_utils.localize(p),
    lambda p: io_utils.save_npz(p, v=np.zeros(1)),
    lambda p: io_utils.save_npy(p, np.zeros(1)),
    lambda p: io_utils.load_npz(p)],
    ids=["makedirs", "open_file", "exists", "listdir", "localize",
         "save_npz", "save_npy", "load_npz"])
def test_unregistered_scheme_raises_naming_register_scheme(call, tmp_path,
                                                           monkeypatch):
  monkeypatch.chdir(tmp_path)
  with pytest.raises(ValueError, match=r"gs://.*register_scheme"):
    call("gs://bucket/run/x.npz")
  assert os.listdir(tmp_path) == []


def _artifacts(root: Path) -> set:
  return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()}


def test_cli_train_resume_eval_sample_on_a_scheme_workdir(myfs):
  """Every artifact of the four modes lands under the mirror root: the
  checkpoints, the snapshot grid and its ``sample.np``, ``stdout.txt``,
  TensorBoard, the trace, the eval and the generated files."""
  wd = "myfs://bucket/wd"
  common = ["--config", FLAGSHIP, "--workdir", wd] + TINY
  first = main.main(common + TRAIN + ["--config.training.n_iters=2",
                                      "--config.training.trace_steps=1"])
  assert first["initial_step"] == 0 and first["step"] == 2
  second = main.main(common + TRAIN + ["--config.training.n_iters=4"])
  assert second["initial_step"] == 2
  (record,) = main.main(common + [
      "--mode", "eval", "--device", "cpu", "--config.eval.begin_ckpt=2",
      "--config.eval.end_ckpt=2", "--config.eval.batch_size=4",
      "--config.eval.enable_sampling=True", "--config.eval.num_samples=4"])
  assert np.isfinite(record["mean_loss"])
  rounds = main.main(common + ["--mode", "sample", "--device", "cpu",
                               "--config.eval.batch_size=4"])
  assert [r["samples"] for r in rounds] == [4]

  local = myfs / "bucket" / "wd"
  found = _artifacts(local)
  want = {"checkpoints/checkpoint_1.pth", "checkpoints/checkpoint_2.pth",
          "checkpoints-meta/checkpoint.pth", "samples/iter_2/sample.np",
          "samples/iter_2/sample.png", "samples/iter_4/sample.np",
          "samples/iter_4/sample.png", "stdout.txt",
          "profile/steps_1-1_rank0.pt.trace.json", "eval/ckpt_2_loss.npz",
          "eval/ckpt_2_samples_0.npz", "generated/samples_0.npz",
          "generated/samples_0.png"}
  assert want <= found, sorted(want - found)
  assert not any(f.endswith(".tmp") for f in found), sorted(found)
  # The reference's snapshot file name, an .npy payload without the suffix.
  grid = np.load(local / "samples" / "iter_2" / "sample.np")
  assert grid.shape == (4, 16, 16, 3) and np.isfinite(grid).all()
  with np.load(local / "eval" / "ckpt_2_loss.npz") as z:
    assert np.isfinite(z["mean_loss"])
  # The log through the handler: a new file per run, as the JAX package.
  log = (local / "stdout.txt").read_text()
  assert "Sampling from checkpoint_2" in log
  tensorboard = [f for f in found if f.startswith("tensorboard/")]
  try:
    import tensorboardX  # noqa: F401
  except ImportError:
    assert tensorboard == []
  else:
    assert tensorboard


def test_scheme_workdir_resumes_what_a_local_one_does(myfs, tmp_path):
  """The same train -> resume on a ``myfs://`` and on a local workdir log
  the same losses (the checkpoint round-trips through the handler)."""
  logged = []
  for wd in ("myfs://bucket/same", str(tmp_path / "local")):
    common = ["--config", FLAGSHIP, "--workdir", wd] + TINY + TRAIN
    main.main(common + ["--config.training.n_iters=2",
                        "--config.training.snapshot_sampling=False"])
    second = main.main(common + ["--config.training.n_iters=4",
                                 "--config.training.snapshot_sampling=False"])
    assert second["initial_step"] == 2
    logged.append(second["train_losses"] + second["eval_losses"])
  assert logged[0] == logged[1]


def test_unregistered_scheme_workdir_raises_before_any_step(tmp_path,
                                                            monkeypatch):
  monkeypatch.chdir(tmp_path)
  for mode in ("train", "eval", "sample"):
    with pytest.raises(ValueError, match="register_scheme"):
      main.main(["--config", FLAGSHIP, "--workdir", "gs://bucket/run",
                 "--mode", mode, "--device", "cpu"] + TINY)
  assert os.listdir(tmp_path) == []


class _RemoteStore:
  """A handler with no local paths (``localize`` returns the URI, as a
  remote store's does), keeping files in a dict."""

  def __init__(self):
    self.files = {}

  def localize(self, path):
    return path

  def makedirs(self, path):
    pass

  def exists(self, path):
    return any(k == path or k.startswith(path.rstrip("/") + "/")
               for k in self.files)

  def listdir(self, path):
    prefix = path.rstrip("/") + "/"
    return sorted({k[len(prefix):].split("/")[0] for k in self.files
                   if k.startswith(prefix)})

  def open(self, path, mode):
    import io
    store = self
    binary = "b" in mode

    class _Writer(io.BytesIO if binary else io.StringIO):
      def close(self):
        value = self.getvalue()
        store.files[path] = value if binary else value.encode()
        super().close()

    if "w" in mode:
      return _Writer()
    data = self.files[path]
    return io.BytesIO(data) if binary else io.StringIO(data.decode())


def test_checkpoints_through_a_handler_without_local_paths(tmp_path,
                                                           monkeypatch):
  """No rename there: the checkpoint is written through ``open_file`` to
  its final name, listed and restored through the handler."""
  monkeypatch.chdir(tmp_path)
  store = _RemoteStore()
  io_utils.register_scheme("remote", store)
  try:
    cfg = configs.load_config(FLAGSHIP, [a[len("--config."):] for a in TINY])
    model = mutils.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
    state = losses.init_train_state(cfg, model, "cpu")
    state["step"] = 7
    wd = "remote://bucket/run"
    checkpoint.save_train_state(checkpoint.numbered_path(wd, 3), state)
    assert list(store.files) == ["remote://bucket/run/checkpoints/"
                                 "checkpoint_3.pth"]
    assert checkpoint.latest_numbered(wd) == 3
    assert checkpoint.has_numbered(wd, 3) and not checkpoint.has_numbered(
        wd, 2)
    other = mutils.create_model(cfg, "cpu", torch.Generator().manual_seed(1))
    assert checkpoint.restore_ema(checkpoint.numbered_path(wd, 3),
                                  other) == 7
    for a, b in zip(model.state_dict().values(),
                    other.state_dict().values()):
      assert torch.equal(a, b)
  finally:
    io_utils.unregister_scheme("remote")
  assert os.listdir(tmp_path) == []


def test_local_checkpoint_write_is_a_rename(tmp_path, monkeypatch):
  """On a local path (and a mirror) the write goes to a temporary name
  that is renamed into place."""
  renamed = []
  real = os.replace
  monkeypatch.setattr(os, "replace",
                      lambda a, b: (renamed.append((a, b)), real(a, b)))
  path = str(tmp_path / "checkpoints" / "checkpoint_1.pth")
  checkpoint._write({"step": 1}, path)
  assert renamed == [(path + ".tmp", path)]
  assert glob.glob(str(tmp_path / "checkpoints" / "*")) == [path]


def test_train_and_sample_through_a_handler_without_local_paths(
    tmp_path, monkeypatch):
  """Every file of a train run (trace included) and a sample run lands in
  the store; TensorBoard, which does its own I/O, is left out; nothing is
  written locally."""
  monkeypatch.chdir(tmp_path)
  store = _RemoteStore()
  io_utils.register_scheme("remote", store)
  try:
    common = ["--config", FLAGSHIP, "--workdir", "remote://b/wd"] + TINY
    main.main(common + TRAIN + ["--config.training.n_iters=2",
                                "--config.training.trace_steps=1"])
    main.main(common + ["--mode", "sample", "--device", "cpu",
                        "--config.eval.batch_size=4"])
  finally:
    io_utils.unregister_scheme("remote")
  files = {k[len("remote://b/wd/"):] for k in store.files}
  assert files == {
      "checkpoints/checkpoint_1.pth", "checkpoints-meta/checkpoint.pth",
      "samples/iter_2/sample.np", "samples/iter_2/sample.png", "stdout.txt",
      "profile/steps_1-1_rank0.pt.trace.json", "generated/samples_0.npz",
      "generated/samples_0.png"}, sorted(files)
  assert b"Sampling from checkpoint_1" in store.files["remote://b/wd/"
                                                      "stdout.txt"]
  assert os.listdir(tmp_path) == []
