"""The port's gpuprobe shim (``csrc/gpuprobe.cpp``, built with the host
C++ compiler at first use) and its ctypes binding: the stat-only device
probe's errno contract on a real char device and on fixture files, the
char major, the NUMA read against the fixtures, and the inotify watch."""

import errno
import os
import shutil
import threading
import time

import pytest

from tpu_k8s_device_plugin_torch import build
from tpu_k8s_device_plugin_torch.hostinfo import gpuprobe

pytestmark = pytest.mark.skipif(
    shutil.which(os.environ.get("CXX") or "g++") is None
    and shutil.which("c++") is None,
    reason="no host C++ compiler to build the gpuprobe shim")


def gpu_dir(testdata, tree="h100-sxm-8", bus="0000:13:00.0"):
    return os.path.realpath(os.path.join(
        testdata, "nvidia", tree, "sys", "bus", "pci", "devices", bus))


def test_version_banner_and_build_location():
    assert gpuprobe.version().startswith("gpuprobe ")
    path = build.host_lib_path("gpuprobe")
    assert path.parent == build.BUILD_DIR and path.exists()


def test_host_lib_path_follows_source_and_flags(monkeypatch):
    before = build.host_lib_path("gpuprobe")
    monkeypatch.setattr(build, "CXX_FLAGS", build.CXX_FLAGS + ["-g"])
    assert build.host_lib_path("gpuprobe") != before


class TestProbeDevice:
    def test_chardev_ok(self):
        assert gpuprobe.probe_device_node("/dev/null") == 0

    def test_missing_is_enoent(self):
        assert gpuprobe.probe_device_node("/nonexistent/nvidia0") == \
            -errno.ENOENT

    def test_regular_file_is_enotsup(self, tmp_path):
        # the reserved "exists but not a chardev" answer that tells
        # fixture trees from a driver-reported ENODEV
        p = tmp_path / "nvidia0"
        p.write_text("")
        assert gpuprobe.probe_device_node(str(p)) == -errno.ENOTSUP

    def test_char_major(self, tmp_path):
        assert gpuprobe.char_device_major("/dev/null") == \
            os.major(os.stat("/dev/null").st_rdev)
        p = tmp_path / "nvidia0"
        p.write_text("")
        assert gpuprobe.char_device_major(str(p)) == -errno.ENOTSUP
        assert gpuprobe.char_device_major("/nonexistent") == -errno.ENOENT


class TestNumaNode:
    def test_fixture_read(self, testdata):
        assert gpuprobe.numa_node(gpu_dir(testdata)) == 0
        assert gpuprobe.numa_node(gpu_dir(testdata, bus="0000:c3:00.0")) == 1

    def test_unknown_collapses_to_zero(self, tmp_path):
        (tmp_path / "numa_node").write_text("-1\n")
        assert gpuprobe.numa_node(str(tmp_path)) == 0

    def test_missing_dir(self):
        assert gpuprobe.numa_node("/nonexistent") < 0


class TestDirWatcher:
    def test_create_event(self, tmp_path):
        with gpuprobe.DirWatcher(str(tmp_path)) as w:
            threading.Timer(
                0.1, lambda: (tmp_path / "kubelet.sock").write_text("")
            ).start()
            t0 = time.monotonic()
            assert w.wait(5.0)
            assert time.monotonic() - t0 < 2.0  # event-driven

    def test_timeout_without_event(self, tmp_path):
        with gpuprobe.DirWatcher(str(tmp_path)) as w:
            assert not w.wait(0.1)

    def test_delete_event(self, tmp_path):
        f = tmp_path / "sock"
        f.write_text("")
        with gpuprobe.DirWatcher(str(tmp_path)) as w:
            w.wait(0.05)
            threading.Timer(0.1, f.unlink).start()
            assert w.wait(5.0)

    def test_missing_dir_raises(self):
        with pytest.raises(OSError):
            gpuprobe.DirWatcher("/nonexistent-dir-xyz")

    def test_deleted_watch_dir_raises_estale(self, tmp_path):
        d = tmp_path / "device-plugins"
        d.mkdir()
        with gpuprobe.DirWatcher(str(d)) as w:
            threading.Timer(0.1, d.rmdir).start()
            with pytest.raises(OSError) as ei:
                for _ in range(50):
                    w.wait(0.2)
            assert ei.value.errno == errno.ESTALE

    def test_closed_watcher_raises(self, tmp_path):
        w = gpuprobe.DirWatcher(str(tmp_path))
        w.close()
        with pytest.raises(ValueError):
            w.wait(0.01)


def test_unbuildable_shim_is_an_import_error(monkeypatch):
    """A host without a compiler degrades callers to portable Python."""
    def boom(name):
        raise RuntimeError("no C++ compiler")
    monkeypatch.setattr(gpuprobe, "_lib", None)
    monkeypatch.setattr(build, "load_host", boom)
    with pytest.raises(ImportError, match=r"no C\+\+ compiler"):
        gpuprobe.load()


def test_health_server_uses_native_probe(testdata):
    """probe_gpu_states goes through the shim and still accepts fixture
    trees (device nodes as regular files)."""
    from tpu_k8s_device_plugin_torch.health import server as hs

    assert hs._gpuprobe() is not None
    root = os.path.join(testdata, "nvidia", "h100-sxm-8")
    states = hs.probe_gpu_states(os.path.join(root, "sys"),
                                 os.path.join(root, "dev"),
                                 os.path.join(root, "proc"))
    assert len(states) == 8
    assert all(s.health == "Healthy" for s in states.values())
