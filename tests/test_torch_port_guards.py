"""Guards of the port, each in a fresh interpreter where ``import jax``
fails: the port and ``chip_smoke.py`` import neither JAX nor the JAX
package, its entry points refuse to slide to the CPU, and the kernel
wrappers never answer a non-CPU request with their plain versions."""

import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, *args):
    prelude = "import sys\nsys.modules['jax'] = None\n"
    return subprocess.run(
        [sys.executable, "-c", prelude + textwrap.dedent(code), *args],
        cwd=ROOT, capture_output=True, text=True, timeout=180)


def test_port_and_smoke_import_without_jax_or_the_jax_package():
    proc = _run("""
        import importlib, pkgutil
        import stemgnn_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            stemgnn_tpu_torch.__path__, "stemgnn_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = [m for m in sys.modules
               if m == "stemgnn_tpu" or m.startswith("stemgnn_tpu.")
               or (m.startswith("jax") and sys.modules[m] is not None)]
        assert not bad, bad
        for mod in ("ops.scatter", "finetune", "train.finetune_loop",
                    "models.task", "utils.metrics", "utils.early_stop",
                    "utils.logger", "data.synthetic", "ops.fused_sage",
                    "ops.edge_layout", "data.importers", "data.kg",
                    "train.infer", "data.raw_parsers", "data.text_encoder",
                    "nn.distilbert", "nn.bert", "nn.llama", "eval.buckets",
                    "eval.perturb", "eval.runner", "ops.reorder",
                    "profile_reorder", "parallel.mesh", "parallel.halo",
                    "parallel.full_graph", "parallel.halo_pretrain",
                    "parallel.data_parallel", "profile_parallel",
                    "utils.splits", "ofa.subgraph", "ofa.prompt",
                    "ofa.datasets", "ofa.fewshot", "ofa.multi", "ofa.tasks",
                    "ofa.heads", "ofa.train", "zoo.resolver", "zoo.mlp",
                    "zoo.convs_rel", "zoo.stack", "zoo.pooling",
                    "zoo.predictors", "zoo.losses",
                    "parallel.edge_partition", "train.trainer", "utils.grid",
                    "utils.timer", "utils.graph_utils",
                    "utils.ckpt_manager"):
            assert "stemgnn_tpu_torch." + mod in names, names
        print(len(names))
    """)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20


def test_port_sources_never_use_cpp_extension():
    hits = []
    for base, _, files in os.walk(os.path.join(ROOT, "stemgnn_tpu_torch")):
        for f in files:
            if f.endswith((".py", ".cu")):
                with open(os.path.join(base, f)) as fh:
                    if "cpp_extension" in fh.read():
                        hits.append(f)
    assert not hits


def test_infer_without_cuda_exits_nonzero_with_a_clear_message():
    proc = _run("""
        import torch
        assert not torch.cuda.is_available()
        from stemgnn_tpu_torch.infer import main
        main(sys.argv[1:])
    """, "--finetune_dataset", "cora_synthetic", "--feat_dim", "8")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "--device cpu" in proc.stderr


def test_finetune_without_cuda_exits_nonzero_with_a_clear_message():
    proc = _run("""
        import torch
        assert not torch.cuda.is_available()
        from stemgnn_tpu_torch.finetune import main
        main(sys.argv[1:])
    """, "--finetune_dataset", "cora_synthetic", "--feat_dim", "8")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "--device cpu" in proc.stderr


def test_ofa_train_eval_without_cuda_raises_instead_of_using_the_cpu():
    """``ofa_train_eval`` and ``fewshot_train_eval`` with ``device=None``
    (the card) raise on a machine without CUDA before any step, and
    neither JAX nor the JAX package is imported on the way."""
    proc = _run("""
        import numpy as np
        import torch
        assert not torch.cuda.is_available()
        from stemgnn_tpu_torch.data.synthetic import synthetic_node_dataset
        from stemgnn_tpu_torch.ofa.datasets import SubgraphNodeDataset
        from stemgnn_tpu_torch.ofa.train import (fewshot_train_eval,
                                                 ofa_train_eval)
        ds = synthetic_node_dataset(num_nodes=60, num_classes=3, feat_dim=8,
                                    num_splits=1, train_per_split=10,
                                    val_per_split=10)
        data = SubgraphNodeDataset(ds, np.eye(3, 8), np.ones((5, 8)),
                                   np.arange(20))
        calls = (
            lambda: ofa_train_eval(data, np.arange(8), np.arange(8, 12),
                                   dim=8, epochs=1),
            lambda: fewshot_train_eval(data, np.asarray(ds.labels),
                                       {"train": [0, 1], "test": [2]},
                                       dim=8, n_way=2, k_shot=1,
                                       train_episodes=2, eval_episodes=2,
                                       epochs=1))
        for call in calls:
            try:
                call()
            except RuntimeError as ex:
                assert "CUDA is not available" in str(ex), ex
                print("raised:", ex)
            else:
                raise SystemExit("ran without CUDA")
        bad = [m for m in sys.modules
               if m == "stemgnn_tpu" or m.startswith("stemgnn_tpu.")
               or (m.startswith("jax") and sys.modules[m] is not None)]
        assert not bad, bad
    """)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("raised:") == 2


def test_chip_smoke_without_cuda_exits_nonzero_with_no_result():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_kernel_wrapper_raises_instead_of_running_the_plain_version():
    proc = _run("""
        import torch
        from stemgnn_tpu_torch.ops import scatter as sc
        assert not torch.cuda.is_available()
        # tensors that are not on the CPU: never the plain version
        m = torch.empty(512, 8, device="meta")
        lrow = torch.empty(1, 512, dtype=torch.int32, device="meta")
        bp = torch.empty(2, dtype=torch.int32, device="meta")
        try:
            sc.scatter_rows_sorted(m, lrow, bp, num_nodes_padded=128)
        except ValueError as ex:
            print("raised:", ex)
        else:
            raise SystemExit("the wrapper returned a result")
        # a CUDA launch on a machine without CUDA: the build refuses
        try:
            sc.load_library()
        except RuntimeError as ex:
            print("raised:", ex)
        else:
            raise SystemExit("load_library succeeded without CUDA")
        # kernel 2: the same on non-CPU tensors, and its build refuses
        x = torch.empty(128, 8, dtype=torch.bfloat16, device="meta")
        keys = torch.empty(1, 512, dtype=torch.int32, device="meta")
        try:
            sc.gathered_scatter_rows_sorted(keys, lrow, bp, x,
                                            num_nodes_padded=128)
        except ValueError as ex:
            print("raised:", ex)
        else:
            raise SystemExit("the wrapper returned a result")
        try:
            sc.load_library("gathered_scatter_rows_sorted")
        except RuntimeError as ex:
            print("raised:", ex)
        else:
            raise SystemExit("load_library succeeded without CUDA")
        # kernel 3: the same
        snd = torch.empty(1, 512, dtype=torch.int32, device="meta")
        try:
            sc.masked_scatter_rows_sorted(m.to(torch.bfloat16), lrow, snd,
                                          bp, x, num_nodes_padded=128)
        except ValueError as ex:
            print("raised:", ex)
        else:
            raise SystemExit("the wrapper returned a result")
        try:
            sc.load_library("masked_scatter_rows_sorted")
        except RuntimeError as ex:
            print("raised:", ex)
        else:
            raise SystemExit("load_library succeeded without CUDA")
        # Linear's split GEMM: the same
        from stemgnn_tpu_torch.ops import split_gemm as sg
        try:
            sg.matmul(m, torch.empty(8, 8, device="meta"))
        except ValueError as ex:
            print("raised:", ex)
        else:
            raise SystemExit("the wrapper returned a result")
        try:
            sc.load_library(sg.KERNEL)
        except RuntimeError as ex:
            print("raised:", ex)
        else:
            raise SystemExit("load_library succeeded without CUDA")
        assert set(sc.launch_counts.values()) == {0}, sc.launch_counts
        assert len(sc.launch_counts) == 4, sc.launch_counts
    """)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("raised:") == 8


def test_pretrain_modules_import_without_jax_or_the_jax_package():
    proc = _run("""
        import importlib
        for mod in ("ops.pairhash", "nn.decoders", "train.augment",
                    "train.optim", "models.pretrain", "train.pretrain_loop",
                    "utils.convert", "profile_pretrain"):
            importlib.import_module("stemgnn_tpu_torch." + mod)
        bad = [m for m in sys.modules
               if m == "stemgnn_tpu" or m.startswith("stemgnn_tpu.")
               or (m.startswith("jax") and sys.modules[m] is not None)]
        assert not bad, bad
        print("imported")
    """)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_profile_pretrain_without_cuda_exits_nonzero_with_a_clear_message():
    proc = _run("""
        import torch
        assert not torch.cuda.is_available()
        from stemgnn_tpu_torch.profile_pretrain import main
        main(sys.argv[1:])
    """, "--feat_dim", "8")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_profile_parallel_without_cuda_exits_nonzero_with_a_clear_message():
    proc = _run("""
        import torch
        assert not torch.cuda.is_available()
        from stemgnn_tpu_torch.profile_parallel import main
        main(sys.argv[1:])
    """, "--only", "dp")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_minibatch_modules_import_without_jax_or_the_jax_package():
    proc = _run("""
        import importlib
        for mod in ("data.sampler", "data.native_sampler", "data.merge",
                    "utils.seeding", "utils.observability", "pretrain",
                    "train.pretrain_loop", "models.task"):
            importlib.import_module("stemgnn_tpu_torch." + mod)
        bad = [m for m in sys.modules
               if m == "stemgnn_tpu" or m.startswith("stemgnn_tpu.")
               or (m.startswith("jax") and sys.modules[m] is not None)]
        assert not bad, bad
        print("imported")
    """)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_kg_and_minibatch_finetune_modules_import_without_jax():
    """The modules of the knowledge-graph slice (the npz caches, the KG
    loader, the layer-wise inference) and the CLIs that use them import
    neither JAX nor the JAX package, and the cache root is the repository's
    own ``data_cache/`` (no path into the JAX package)."""
    proc = _run("""
        import importlib, os
        for mod in ("data.importers", "data.kg", "data.registry",
                    "train.infer", "train.finetune_loop", "finetune",
                    "infer", "eval.runner"):
            importlib.import_module("stemgnn_tpu_torch." + mod)
        bad = [m for m in sys.modules
               if m == "stemgnn_tpu" or m.startswith("stemgnn_tpu.")
               or (m.startswith("jax") and sys.modules[m] is not None)]
        assert not bad, bad
        from stemgnn_tpu_torch.data.importers import DEFAULT_CACHE_ROOT
        assert DEFAULT_CACHE_ROOT == os.path.join(os.getcwd(), "data_cache")
        print("imported")
    """)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_pretrain_cli_without_cuda_exits_nonzero_with_a_clear_message():
    proc = _run("""
        import torch
        assert not torch.cuda.is_available()
        from stemgnn_tpu_torch.pretrain import main
        main(sys.argv[1:])
    """, "--pretrain_dataset", "cora_synthetic", "--feat_dim", "8")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "--device cpu" in proc.stderr


def test_native_sampler_raises_when_it_cannot_be_built():
    """``use_native=True`` (the default) never slides to the numpy sampler:
    with a compiler that is missing, or one that fails, building into an
    empty directory, the iterator raises with the compiler's command."""
    proc = _run("""
        import tempfile
        import numpy as np
        from stemgnn_tpu_torch.data import native_sampler
        from stemgnn_tpu_torch.data.sampler import (CSCGraph,
                                                    NeighborBatchIterator)
        from stemgnn_tpu_torch.utils import native_build
        ei = np.array([[1, 2, 3], [0, 0, 1]])
        for cxx in ("/nonexistent/bin/g++", "false"):
            native_build.CXX = cxx
            native_build.BUILD_DIR = tempfile.mkdtemp()
            native_sampler._libs.clear()
            try:
                NeighborBatchIterator(CSCGraph.from_edge_index(ei, 4),
                                      np.arange(4), None, np.arange(4), 2,
                                      [2], np.random.default_rng(0))
            except RuntimeError as ex:
                assert cxx in str(ex), ex
                print("raised:", ex)
            else:
                raise SystemExit(f"built with the compiler {cxx}")
        it = NeighborBatchIterator(CSCGraph.from_edge_index(ei, 4),
                                   np.arange(4), None, np.arange(4), 2, [2],
                                   np.random.default_rng(0),
                                   use_native=False)
        assert not it._native
    """)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("raised:") == 2


def test_port_never_reads_the_jax_native_directory():
    """The port builds its own copy of the sampler source into its own
    build directory; no port file names the JAX package's native
    directory or library."""
    hits = []
    for base, _, files in os.walk(os.path.join(ROOT, "stemgnn_tpu_torch")):
        if "_build" in base:
            continue
        for f in files:
            if f.endswith((".py", ".cu", ".cuh", ".cpp")):
                with open(os.path.join(base, f)) as fh:
                    text = fh.read()
                if "stemgnn_tpu/native" in text or \
                        "libstemgnn_sampler" in text or \
                        '"native"' in text:
                    hits.append(f)
    assert not hits
    proc = _run("""
        from stemgnn_tpu_torch.data import native_sampler
        print(native_sampler.SOURCE)
        print(native_sampler.library_path())
    """)
    src, lib = proc.stdout.split()
    assert src == os.path.join(ROOT, "stemgnn_tpu_torch", "csrc",
                               "sampler.cpp")
    assert lib.startswith(os.path.join(ROOT, "stemgnn_tpu_torch", "_build"))


def test_graph_task_modules_import_without_jax_or_the_jax_package():
    """The graph-task slice (the featurizer, the hash text encoder, the
    molecule datasets, pooling and the AUCs, the graph half of the finetune
    loop) imports neither JAX nor the JAX package."""
    proc = _run("""
        import importlib
        for mod in ("data.chem", "data.text_encoder", "data.synthetic",
                    "data.registry", "ops.segment", "models.task",
                    "utils.metrics", "train.finetune_loop", "finetune",
                    "infer"):
            importlib.import_module("stemgnn_tpu_torch." + mod)
        from stemgnn_tpu_torch.train.finetune_loop import (
            _run_graph_task, graph_task_encode, graph_task_predict)
        bad = [m for m in sys.modules
               if m == "stemgnn_tpu" or m.startswith("stemgnn_tpu.")
               or (m.startswith("jax") and sys.modules[m] is not None)]
        assert not bad, bad
        print("imported")
    """)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_graph_task_does_not_slide_to_the_cpu():
    """``run_finetune`` of a graph task asked for CUDA on a machine without
    it raises before any step, on both bundle forms; the CLI exits
    non-zero with the same message."""
    proc = _run("""
        import tempfile
        import torch
        assert not torch.cuda.is_available()
        from stemgnn_tpu_torch.core.config import (EncoderConfig,
                                                   FinetuneConfig, VQConfig)
        from stemgnn_tpu_torch.data.registry import load_dataset
        from stemgnn_tpu_torch.data.synthetic import write_smiles_csv
        from stemgnn_tpu_torch.train.finetune_loop import run_finetune
        path = tempfile.mktemp(suffix=".csv")
        write_smiles_csv(path, 20, num_tasks=2)
        cfg = FinetuneConfig(
            encoder=EncoderConfig(input_dim=8, hidden_dim=8),
            vq=VQConfig(dim=8, codebook_dim=8, codebook_size=4, heads=2),
            task="graph", num_classes=2, epochs=1, repeat=1)
        for name in ("mol_synthetic", "smiles:" + path):
            ds = load_dataset(name, feat_dim=8)
            cfg2 = cfg.__class__(**{**cfg.__dict__,
                                    "num_classes": ds[1].shape[1]})
            try:
                run_finetune(ds, cfg2, device="cuda")
            except RuntimeError as ex:
                assert "CUDA is not available" in str(ex), ex
                print("raised:", name)
            else:
                raise SystemExit("the graph task ran without CUDA")
        from stemgnn_tpu_torch.finetune import main
        main(["--finetune_dataset", "mol_synthetic", "--feat_dim", "8"])
    """)
    assert proc.returncode != 0
    assert proc.stdout.count("raised:") == 2, proc.stdout + proc.stderr
    assert "CUDA is not available" in proc.stderr


def test_backbone_modules_import_without_jax_or_the_jax_package():
    """The MoE-SAGE and gcn / gin / gat slice (the convs, the encoder, the
    decoders, the segment softmax, the layer-wise inference, the
    reference-checkpoint importer) imports neither JAX nor the JAX
    package, and builds and runs each backbone's encoder and the importer
    without them."""
    proc = _run("""
        import importlib
        for mod in ("nn.convs", "nn.encoder", "nn.decoders", "nn.init",
                    "ops.segment", "train.infer", "utils.torch_import",
                    "models.pretrain", "models.task", "train.finetune_loop",
                    "train.pretrain_loop", "eval.runner", "scripts._common"):
            importlib.import_module("stemgnn_tpu_torch." + mod)
        import numpy as np
        import torch
        from stemgnn_tpu_torch.core.config import EncoderConfig
        from stemgnn_tpu_torch.nn.encoder import Encoder
        from stemgnn_tpu_torch.utils.torch_import import import_encoder
        s = torch.arange(20) % 10
        r = (s * 3 + 1) % 10
        for bb, moe in (("gcn", "none"), ("gin", "none"), ("gat", "none"),
                        ("sage", "last")):
            cfg = EncoderConfig(input_dim=8, hidden_dim=8, backbone=bb,
                                moe=moe != "none", moe_layers=moe)
            z, aux = Encoder(cfg).train()(torch.randn(10, 8), s, r,
                                          return_aux=True)
            assert z.shape == (10, 8) and torch.isfinite(z).all()
            assert (float(aux["env_reg"]) < 0) == (moe != "none")
        sd = {f"layers.{i}.{k}.weight": np.ones((8, 8), np.float32)
              for i in range(2) for k in ("lin_l", "lin_r")}
        sd.update({f"layers.{i}.lin_l.bias": np.zeros(8, np.float32)
                   for i in range(2)})
        for i in range(2):
            for k, v in (("weight", 1.0), ("bias", 0.0),
                         ("running_mean", 0.0), ("running_var", 1.0)):
                sd[f"norms.{i}.{k}"] = np.full(8, v, np.float32)
        import_encoder(sd, EncoderConfig(input_dim=8, hidden_dim=8))
        bad = [m for m in sys.modules
               if m == "stemgnn_tpu" or m.startswith("stemgnn_tpu.")
               or (m.startswith("jax") and sys.modules[m] is not None)]
        assert not bad, bad
        print("imported")
    """)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_halo_finetune_does_not_slide_to_the_cpu():
    """``--halo_shards`` without a card and without ``--device cpu`` exits
    non-zero with the port's message before a rank is spawned, and the
    halo modules run a world of one rank on the CPU without JAX; a CUDA
    rank is refused where no card is visible."""
    proc = _run("""
        import os, tempfile
        import torch
        assert not torch.cuda.is_available()
        from stemgnn_tpu_torch.parallel import mesh
        tmp = tempfile.mkdtemp()
        ranks = mesh.init_ranks(0, 1, "cpu", store=os.path.join(tmp, "s"))
        assert ranks.backend == "gloo" and ranks.device.type == "cpu"
        x = torch.arange(6.).reshape(3, 2)
        from stemgnn_tpu_torch.parallel.halo import halo_exchange
        got = halo_exchange(x, torch.tensor([[2, 0]]), ranks)
        assert torch.equal(got, x[[2, 0]])
        ranks.close()
        try:
            mesh.check_world(1, "cuda")
        except RuntimeError as ex:
            assert "--device cpu" in str(ex)
        else:
            raise AssertionError("a CUDA rank without a card")
        bad = [m for m in sys.modules
               if m == "stemgnn_tpu" or m.startswith("stemgnn_tpu.")
               or (m.startswith("jax") and sys.modules[m] is not None)]
        assert not bad, bad
        from stemgnn_tpu_torch.finetune import main
        main(["--finetune_dataset", "cora_synthetic", "--feat_dim", "8",
              "--halo_shards", "2"])
    """)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr, proc.stderr
    assert "--device cpu" in proc.stderr
    assert "Halo full-graph finetune" not in proc.stdout


@pytest.mark.parametrize("flags", [["--halo_shards", "2"],
                                   ["--data_parallel"]])
def test_multi_gpu_pretrain_does_not_slide_to_the_cpu(flags):
    """``pretrain --halo_shards`` / ``--data_parallel`` without a card and
    without ``--device cpu`` exit non-zero with the port's message before
    a rank is spawned or a dataset is loaded."""
    proc = _run("""
        import torch
        assert not torch.cuda.is_available()
        from stemgnn_tpu_torch.pretrain import main
        main(sys.argv[1:])
    """, "--pretrain_dataset", "cora_synthetic", "--feat_dim", "8", *flags)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr, proc.stderr
    assert "--device cpu" in proc.stderr
    assert "Pre-training on" not in proc.stdout


def test_edge_parallel_finetune_does_not_slide_to_the_cpu():
    """``launch_edge_parallel_finetune`` without a card and without
    ``device_type="cpu"`` raises naming the CPU request before a rank is
    spawned or a line printed, and without JAX or the JAX package."""
    proc = _run("""
        import torch
        assert not torch.cuda.is_available()
        from stemgnn_tpu_torch.core.config import (EncoderConfig,
                                                   FinetuneConfig, VQConfig)
        from stemgnn_tpu_torch.data.synthetic import synthetic_node_dataset
        from stemgnn_tpu_torch.parallel.full_graph import \\
            launch_edge_parallel_finetune
        ds = synthetic_node_dataset(num_nodes=60, num_classes=3, feat_dim=8,
                                    num_splits=1, train_per_split=10,
                                    val_per_split=10)
        cfg = FinetuneConfig(
            encoder=EncoderConfig(input_dim=8, hidden_dim=8, num_layers=2),
            vq=VQConfig(dim=8, codebook_size=4, codebook_dim=4, heads=2),
            num_classes=3, epochs=1, repeat=1)
        bad = [m for m in sys.modules
               if m == "stemgnn_tpu" or m.startswith("stemgnn_tpu.")
               or (m.startswith("jax") and sys.modules[m] is not None)]
        assert not bad, bad
        launch_edge_parallel_finetune(ds, cfg, 2)
    """)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr, proc.stderr
    assert "device_type='cpu'" in proc.stderr
    assert "Edge-parallel full-graph finetune" not in proc.stdout
