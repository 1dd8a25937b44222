"""The one backend module: platform check, peaks table, compile cache."""

import os

import jax
import pytest

from canopy_tpu import device
from canopy_tpu.cli import PLATFORMS, build_parser
from canopy_tpu.utils.profiling import RooflineAccountant

H100 = "NVIDIA H100 80GB HBM3"


class TestPeaks:
    def test_h100_published_figures(self):
        peaks = device.peaks(H100)
        assert peaks.hbm_bytes_per_s == 3.35e12
        assert peaks.bf16_flops == 989e12
        assert peaks.tf32_flops == 495e12
        assert peaks.f32_flops == 67e12
        assert "H100" in peaks.source

    @pytest.mark.parametrize("kind", ["cpu", "TPU v5 lite", "NVIDIA A100",
                                      "nvidia h100 80gb hbm3", ""])
    def test_unknown_device_raises(self, kind):
        with pytest.raises(KeyError, match="no published peaks"):
            device.peaks(kind)

    def test_default_is_first_device(self):
        # The test session runs on the CPU, which has no peaks.
        with pytest.raises(KeyError, match="'cpu'"):
            device.peaks()

    def test_roofline_accountant_reads_table(self):
        acc = RooflineAccountant(H100)
        entry = acc.record("gather", elements=3_350_000_000,
                           bytes_per_element=4.0, seconds=8e-3)
        # 3.35e9 * 4 B / 3.35e12 B/s = 4 ms ideal; 8 ms actual -> 0.5.
        assert entry["hbm_fraction"] == pytest.approx(0.5)

    def test_roofline_accountant_unknown_device_raises(self):
        with pytest.raises(KeyError):
            RooflineAccountant("TPU v5 lite")


class TestPlatform:
    def test_backend_is_the_one_query(self):
        assert device.backend() == jax.default_backend() == "cpu"

    def test_require_gpu_refuses_cpu(self):
        with pytest.raises(RuntimeError, match="GPU is required"):
            device.require_gpu()

    def test_no_other_module_asks_the_backend(self):
        root = os.path.dirname(device.__file__)
        offenders = []
        for dirpath, _dirs, names in os.walk(root):
            for name in names:
                path = os.path.join(dirpath, name)
                if name.endswith(".py") and path != device.__file__:
                    with open(path) as fh:
                        if "default_backend(" in fh.read():
                            offenders.append(path)
        assert offenders == []

    @pytest.mark.parametrize("choice,platform", [("cpu", "cpu"),
                                                 ("gpu", "cuda")])
    def test_cli_platform_choices(self, choice, platform):
        args = build_parser().parse_args(["m.xml", "--platform", choice])
        assert PLATFORMS[args.platform] == platform

    @pytest.mark.parametrize("choice", ["tpu", "cuda", "GPU"])
    def test_cli_rejects_other_platforms(self, choice, capsys):
        with pytest.raises(SystemExit):
            build_parser().parse_args(["m.xml", "--platform", choice])


class TestCompileCache:
    @pytest.fixture(autouse=True)
    def restore(self):
        saved = jax.config.jax_compilation_cache_dir
        yield
        jax.config.update("jax_compilation_cache_dir", saved)

    def test_environment_variable_wins(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        jax.config.update("jax_compilation_cache_dir", None)
        assert device.setup_compile_cache() == str(tmp_path)
        # No other directory is configured in code.
        assert jax.config.jax_compilation_cache_dir is None

    def test_default_is_fixed_checkout_path(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = device.setup_compile_cache()
        checkout = os.path.dirname(os.path.dirname(device.__file__))
        assert path == os.path.join(checkout, ".jax_cache")
        assert path == device.default_cache_dir()
        assert jax.config.jax_compilation_cache_dir == path

    def test_default_path_does_not_depend_on_cwd(self, monkeypatch,
                                                 tmp_path):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        first = device.default_cache_dir()
        monkeypatch.chdir(tmp_path)
        assert device.default_cache_dir() == first
