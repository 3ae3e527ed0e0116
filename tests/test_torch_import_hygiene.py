"""The PyTorch port imports neither JAX, ml_dtypes (absent where the
kernels run) nor the JAX package, and importing any of its modules builds
no kernel and no native host library."""

import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax_and_builds_nothing():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import compressed_tensors_tpu_torch as pkg
        from compressed_tensors_tpu_torch.ops.kernels import _build
        from compressed_tensors_tpu_torch.utils import native
        names = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        for mod in ("ops.kernels.w4a16_matmul", "ops.kernels.w8a8_matmul",
                    "ops.kernels.flash_decode", "ops.kernels.paged_decode",
                    "engine.serving", "engine.generate", "ops.fp4",
                    "ops.fp4_pack", "ops.mx", "compressors.nvfp4",
                    "ops.bitmask", "compressors.sparse",
                    "quantization.lifecycle", "quantization.quant_metadata",
                    "modeling.attention", "linear.compressed_linear",
                    "utils.native", "utils.impl_backend", "utils.mtp",
                    "logger", "version", "transform", "transform.schemas",
                    "transform.hadamard", "transform.hadamard_data",
                    "transform.apply", "entrypoints", "entrypoints.convert",
                    "entrypoints.convert.converters",
                    "entrypoints.convert.convert_checkpoint",
                    "offload", "offload.cache", "offload.dispatch",
                    "offload.load", "distributed", "distributed.utils",
                    "distributed.assign", "distributed.module_parallel",
                    "parallel", "parallel.mesh", "parallel.overlap",
                    "parallel.pipeline"):
            assert "compressed_tensors_tpu_torch." + mod in names, mod
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "ml_dtypes" or m.startswith("ml_dtypes.")
                     or m == "compressed_tensors_tpu"
                     or m.startswith("compressed_tensors_tpu."))
        assert not bad, bad
        assert _build._lib is None
        assert native._LIB is None and not native._TRIED
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


def test_sharded_loading_and_parallel_import_alone_without_jax():
    """``offload.load`` (``load_sharded_params``) and ``parallel``, each
    imported first and alone, pull in neither JAX nor the JAX package."""
    for module in ("offload.load", "parallel"):
        code = textwrap.dedent(f"""
            import sys
            import compressed_tensors_tpu_torch.{module}
            bad = sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "ml_dtypes",
                                                "compressed_tensors_tpu"))
            assert not bad, bad
        """)
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, (module, out.stderr)
