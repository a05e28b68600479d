"""Guards of the port, each in a fresh interpreter where ``import jax``
fails: the port and ``chip_smoke.py`` import neither JAX nor the JAX
package, its entry points refuse to slide to the CPU, and the kernel
wrappers never answer a non-CPU request with their plain versions."""

import os
import subprocess
import sys
import textwrap

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
                    "utils.logger"):
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
        assert set(sc.launch_counts.values()) == {0}, sc.launch_counts
    """)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("raised:") == 4
