"""PyTorch port, the dispatch units that a card runs as CUDA graphs
(``utils/graphs.py``), on the CPU: no unit makes the host wait for the
device or moves data between the two, the state a graph bakes keeps its
storage, dispatch units map to the JAX package's compiled variants, and the
rules of where graphs run.

The CPU has no graphs (the eager step is its path), so the graphs
themselves, replayed against the eager path, are held on the card in
``tests/test_torch_cuda.py``."""

import inspect
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from light_unet_tpu.utils import nifti
from light_unet_tpu_torch import cli, config as port_config
from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.core.trainer import Trainer
from light_unet_tpu_torch.models.fused_forward import make_fused_apply
from light_unet_tpu_torch.models.unet3d import build_model, init_weights
from light_unet_tpu_torch.ops import block_kernel, norm_kernel
from light_unet_tpu_torch.ops.sliding_window import chunk_forward
from light_unet_tpu_torch.utils import graphs
from light_unet_tpu_torch.utils.device import precision_scope
from tests.synthetic import make_phantom, write_split_files
from tests.torch_parity import one_torch_thread  # noqa: F401 (fixture)

FL, DLBCL, VAL = ["0001", "0002"], ["1001", "1002"], ["0003"]
MODES = ["standard", "probabilistic", "fl_epoch_plus_dlbcl"]

# ops that make the host wait for the device (a scalar read, a data-dependent
# shape, a comparison answered on the host) or bring host data into the unit
SYNC_OPS = {"_local_scalar_dense", "item", "nonzero", "nonzero_static", "masked_select",
            "unique", "_unique", "_unique2", "unique_dim", "unique_consecutive",
            "unique_dim_consecutive", "is_nonzero", "equal", "lift_fresh"}


class HostSyncRecorder(TorchDispatchMode):
    """Records every op of a region that would stall a CUDA graph capture
    on a card: ``SYNC_OPS``, an index by a boolean mask, and any copy
    between two devices."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in SYNC_OPS:
            self.found.append(name)
        elif name == "_to_copy" and kwargs.get("device") is not None \
                and torch.device(kwargs["device"]) != args[0].device:
            self.found.append(f"_to_copy to {kwargs['device']}")
        elif name == "copy_" and isinstance(args[1], torch.Tensor) \
                and args[0].device != args[1].device:
            self.found.append(f"copy_ {args[1].device} -> {args[0].device}")
        elif name in ("index", "index_put", "index_put_", "_index_put_impl_") and any(
                isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                for i in args[1]):
            self.found.append(f"{name} by a mask")  # a data-dependent shape (nonzero)
        return func(*args, **kwargs)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A processed tree of 20x24x28 phantoms: FL 0001-0003, DLBCL 1001-1002;
    ``splits`` trains on FL + DLBCL, ``splits_fl`` on FL."""
    tmp = tmp_path_factory.mktemp("graphs")
    rng = np.random.default_rng(31)
    data = tmp / "proc"
    (data / "images").mkdir(parents=True)
    (data / "labels").mkdir()
    aff = np.diag([4.0, 4.0, 4.0, 1.0])
    for cid in FL + DLBCL + VAL:
        img, lab = make_phantom(rng, shape=(20, 24, 28))
        img = np.clip(img / 9.0, 0.0, 1.0).astype(np.float32)
        nifti.save(nifti.Nifti1Image(img, aff), data / f"images/{cid}_0000.nii.gz")
        nifti.save(nifti.Nifti1Image(lab.astype(np.uint8), aff), data / f"labels/{cid}.nii.gz")
    write_split_files(tmp / "splits", FL + DLBCL, VAL)
    write_split_files(tmp / "splits_fl", FL, VAL)
    return tmp


def _cfg(tree, mode, **tpu):
    cfg = {
        "data": {"patch_size": [16, 16, 16], "body_mask": {"enabled": False}},
        "model": {"encoder_channels": [4, 8, 16, 32], "groups": 4},
        "tpu": {"compute_dtype": "float32", "patch_batch": 16, "z_bucket": 16,
                "steps_per_dispatch": 4, "separable_augment": True, **tpu},
        "training": {"batch_size": 2, "epochs": 2, "learning_rate": 1e-3, "warmup_epochs": 1},
        "output": {"save_every_n_epochs": 1},
        "data_dir": str(tree / "proc"),
        "splits_dir": str(tree / ("splits_fl" if mode == "standard" else "splits")),
    }
    if mode != "standard":
        cfg["training"]["mixed_domains"] = {"enabled": True, "mode": mode, "dlbcl_steps": 5}
    return cfg


def _trainer(tree, name, mode, **tpu):
    return Trainer(Config.from_dict(_cfg(tree, mode, **tpu)), workdir=str(tree / name),
                   device="cpu")


@pytest.fixture(scope="module")
def corpus_trainers(tree):
    return {m: _trainer(tree, f"corpus_{m}", m) for m in MODES}


def _loader(tr):
    return tr.dlbcl_loader if tr.mode == "fl_epoch_plus_dlbcl" else tr.train_loader


def test_recorder_sees_host_syncs():
    """The recorder the tests below rely on catches a scalar read, a
    boolean-mask index, a tensor made from host data and a device copy."""
    x = torch.arange(6.0)
    with HostSyncRecorder() as rec:
        float(x.sum())
        _ = x[x > 2]
        _ = x * torch.tensor(2.0)
        _ = x.to("meta")
    assert {"_local_scalar_dense", "index by a mask", "lift_fresh"} <= set(rec.found)
    assert any(f.startswith("_to_copy to meta") for f in rec.found), rec.found


@pytest.mark.parametrize("unit", ["chain", "tail_chain", "single_step"])
@pytest.mark.parametrize("mode", MODES)
def test_corpus_unit_makes_no_host_sync(corpus_trainers, mode, unit):
    """The function a corpus dispatch unit captures (gather -> dequantize ->
    augment -> forward -> loss -> gradients -> guarded AdamW, K times) makes
    no op that would sync or leave the device; it returns [2, K]."""
    tr = corpus_trainers[mode]
    assert tr.corpus is not None and tr._chain == 4
    loader = _loader(tr)
    k = {"chain": 4, "tail_chain": 2, "single_step": 1}[unit]
    chain = torch.from_numpy(np.stack([loader.sample_corners() for _ in range(k)]))
    tr.model.train()
    with precision_scope(tr.compute_dtype), HostSyncRecorder() as rec:
        out = tr._corpus_unit(chain)
    assert rec.found == []
    assert out.shape == (2, k) and torch.isfinite(out).all() and (out[1] == 1).all()


@pytest.mark.parametrize("mode", MODES)
def test_host_batch_unit_makes_no_host_sync(tree, mode):
    """The host-batch step (``tpu.transfer_dtype: float32``, no corpus)."""
    tr = _trainer(tree, f"host_{mode}", mode, transfer_dtype="float32")
    assert tr.corpus is None and tr._chain == 1
    loader = tr.fl_loader if mode == "fl_epoch_plus_dlbcl" else tr.train_loader
    images, labels = next(iter(loader))
    assert Trainer._unit_key((images, labels)) == ("host",)
    images, labels = torch.from_numpy(images), torch.from_numpy(labels)
    tr.model.train()
    with precision_scope(tr.compute_dtype), HostSyncRecorder() as rec:
        out = tr._host_unit(images, labels)
    assert rec.found == []
    assert out.shape == (2, 1) and torch.isfinite(out).all()


def _model(route, dtype=torch.float32):
    cfg = Config.from_dict({"model": {"encoder_channels": [4, 8, 16, 32], "groups": 4}})
    model = build_model(cfg.model, dtype, inference=True)
    init_weights(model, torch.Generator().manual_seed(2)).eval()
    return make_fused_apply(model) if route == "fused_block" else model


@pytest.mark.parametrize("route", ["fused_block", "plain"])
def test_chunk_forward_makes_no_host_sync(route):
    """One chunk's forward, as the window captures it, in each route (the
    kernels' plain versions on the CPU); the unit's key holds the network's
    identity, which tells the two routes apart."""
    apply_fn = _model(route)
    chunk = torch.from_numpy(np.random.default_rng(0).random((8, 16, 16, 16), np.float32))
    with torch.no_grad(), HostSyncRecorder() as rec:
        out = chunk_forward(apply_fn, chunk)
    assert rec.found == []
    assert out.shape == chunk.shape and out.dtype == torch.float32
    assert graphs.unit_key("window", apply_fn)[1:4:2] == (torch.float32, id(apply_fn))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_the_use_pallas_key_selects_nothing(tmp_path, use_pallas):
    """``tpu.use_pallas`` is read and ignored: the models that ``bench`` and
    ``Inferencer`` build under it have the default config's parameter names
    and its CPU outputs bit for bit, and their graph keys differ from the
    default model's in the network's identity alone."""
    from light_unet_tpu_torch import bench
    from light_unet_tpu_torch.core.inferencer import Inferencer

    ref, _ = bench.seeded_model(Config(), "cpu")
    cfg = Config.from_dict({"tpu": {"use_pallas": use_pallas}})
    model, apply_fn = bench.seeded_model(cfg, "cpu")
    path = tmp_path / "best_model.pth"
    torch.save({"model_state_dict": ref.state_dict(), "epoch": 0}, path)
    inf = Inferencer(cfg, path, workdir=str(tmp_path), device="cpu")
    names = [n for n, _ in ref.named_parameters()]
    x = torch.rand((1, 16, 16, 16, 1), generator=torch.Generator().manual_seed(0))
    ref_key = graphs.unit_key("window", ref, chunk=2)
    with torch.no_grad():
        want = ref(x)
        for net, fn in ((model, apply_fn), (inf.model, inf.sw.apply_fn)):
            assert fn is net and [n for n, _ in net.named_parameters()] == names
            assert torch.equal(net(x), want)
            key = graphs.unit_key("window", fn, chunk=2)
            assert key[:3] + key[4:] == ref_key[:3] + ref_key[4:] and key[3] == id(fn)


def _baked(tr):
    """data_ptr of everything a training graph reads besides its static buffers."""
    opt = tr.opt
    ptrs = {"flat": opt.flat, "mu": opt.mu, "nu": opt.nu, "count": opt.count, "lr": opt.lr,
            "weight_decay": opt.weight_decay, "corpus_images": tr.corpus.images,
            "corpus_labels": tr.corpus.labels}
    ptrs.update({f"param{i}": p for i, p in enumerate(opt.params)})
    return {k: v.data_ptr() for k, v in ptrs.items()}


@pytest.mark.parametrize("mode", MODES)
def test_baked_state_keeps_its_storage(tree, mode):
    """The flat buffer and the parameter views of it, both moments, the step
    count, the learning rate, weight decay and the corpus keep their storage
    across ``set_lr``, an epoch boundary, a validation pass and ``resume``;
    the parameters stay views of the flat buffer."""
    tr = _trainer(tree, f"baked_{mode}", mode)
    want = _baked(tr)
    tr._set_lr(5e-4)
    assert _baked(tr) == want
    tr.train_epoch(0)
    tr.train_epoch(1)
    assert _baked(tr) == want
    tr.validate(0)
    assert _baked(tr) == want
    tr.save_checkpoint_file(0)
    before = tr.opt.flat.clone()
    tr.train_epoch(2)
    assert not torch.equal(tr.opt.flat, before)
    assert tr.resume(tr.checkpoint_dir / "checkpoint_epoch_001.ckpt")
    assert _baked(tr) == want and torch.equal(tr.opt.flat, before)
    off = 0
    for p in tr.opt.params:
        assert p.data_ptr() == tr.opt.flat.data_ptr() + 4 * off
        off += p.numel()


def _keys(n_batches, k):
    units = Trainer._dispatch_units(types.SimpleNamespace(_chain=k),
                                    [np.zeros((2, 4), np.int32)] * n_batches)
    return [Trainer._unit_key(u) for u in units]


@pytest.mark.parametrize("n_batches,k,want", [
    (10, 4, [("chain", 4), ("chain", 4), ("chain", 2)]),
    (9, 4, [("chain", 4), ("chain", 4), ("step",)]),
    (8, 4, [("chain", 4), ("chain", 4)]),
    (3, 1, [("step",)] * 3),
])
def test_units_map_to_the_jax_variants(n_batches, k, want):
    """An epoch of 10 corpus steps at K = 4 is chains of 4, 4 and 2 (the tail
    chain is one more compiled variant, as in the JAX package); a tail of one
    takes the single step, the same key as every step at K = 1."""
    assert _keys(n_batches, k) == want


def test_graph_rules(capsys, monkeypatch):
    """Graphs run on a CUDA device when asked and not over gloo; the eager
    path on a card is logged with its reason; the CPU has no graphs and a
    runner refuses it; a replay adds its capture's launches to the kernels'
    counters.  (No runner here touches the device: it captures at its
    first call.)"""
    cuda = torch.device("cuda")
    assert graphs.runner_for(torch.device("cpu"), True, "train") is None
    assert capsys.readouterr().out == ""
    runner = graphs.runner_for(cuda, True, "train", generators=[torch.Generator()])
    assert isinstance(runner, graphs.GraphRunner) and runner.name == "train"
    assert graphs.runner_for(cuda, True, "train", types.SimpleNamespace(backend="nccl"))
    assert graphs.runner_for(cuda, False, "train") is None
    assert "graphs=False" in capsys.readouterr().out
    assert graphs.runner_for(cuda, True, "train", types.SimpleNamespace(backend="gloo")) is None
    assert "gloo mesh" in capsys.readouterr().out
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.GraphRunner("train", "cpu")
    monkeypatch.setattr(block_kernel, "launches", 5)
    monkeypatch.setattr(norm_kernel, "launches", 7)
    graphs._add_launches((2, 21))
    assert (block_kernel.launches, norm_kernel.launches) == (7, 28)


def test_finish_releases_the_graphs_first(monkeypatch):
    """``distributed.finish`` destroys every live runner's graphs before the
    process group (an NCCL communicator must outlive the graphs that
    captured its collectives); a runner captures again at its next use."""
    from light_unet_tpu_torch.parallel import distributed

    runner = graphs.GraphRunner("train", "cuda")
    runner.graphs[("chain", 4)] = "graph"
    order = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: order.append("sync"))
    monkeypatch.setattr(distributed, "is_distributed_initialized", lambda: True)
    monkeypatch.setattr(distributed.dist, "destroy_process_group",
                        lambda: order.append(("destroy", dict(runner.graphs))))
    distributed.finish()
    assert order == ["sync", ("destroy", {})] and runner.graphs == {}


def test_no_path_falls_back_to_eager():
    """No ``except`` in the graph runner, and neither the config nor the CLI
    names graphs: the eager path is only the explicit constructor argument."""
    assert "except" not in inspect.getsource(graphs)
    for mod in (cli, port_config):
        assert "graphs" not in Path(mod.__file__).read_text()
    for fn in (Trainer.__init__, Trainer._run_unit):
        assert "except" not in inspect.getsource(fn)


def test_cpu_trainer_runs_the_eager_step(tree):
    """On the CPU neither ``graphs=True`` nor ``graphs=False`` makes a runner,
    and both train the same steps."""
    losses = []
    for flag in (True, False):
        tr = Trainer(Config.from_dict(_cfg(tree, "standard")),
                     workdir=str(tree / f"cpu_{flag}"), device="cpu", graphs=flag)
        assert tr.graphs is None and tr.sw.graphs is None
        tr.model.train()
        tr._set_lr(tr.scheduler.current_lr())
        unit = next(iter(tr._dispatch_units(tr.train_loader)))
        losses.append(tr._flatten_losses([tr._step_on_batch(unit)]))
    assert losses[0] == losses[1] and len(losses[0]) == 4
