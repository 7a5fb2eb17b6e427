// gpuprobe: the host shim of the port's NVIDIA device plugin.
//
// The port's own copy of the JAX package's native/tpuprobe/tpuprobe.cpp,
// behind the same flat C ABI (consumed from Python through ctypes by
// hostinfo/gpuprobe.py), plus the char-device major of a node:
//
//   - inotify directory watcher (kubelet socket create/remove detection
//     without polling)
//   - stat-only device-node probe, and the node's char major
//     (/dev/nvidia<minor> is major 195)
//   - NUMA node of a PCI function (sysfs read)
//
// Built by build.py with the host C++ compiler into libgpuprobe; no
// dependency beyond libc/libstdc++, and no CUDA: the agents never create
// a CUDA context.

#include <cerrno>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <poll.h>
#include <sys/inotify.h>
#include <sys/stat.h>
#include <sys/sysmacros.h>
#include <sys/types.h>
#include <unistd.h>

#define GP_API extern "C" __attribute__((visibility("default")))

static const char kVersion[] = "gpuprobe 1.0.0";

GP_API const char* gp_version(void) { return kVersion; }

// ---------------------------------------------------------------------------
// inotify directory watcher
// ---------------------------------------------------------------------------

struct gp_watch {
  int ifd;
  int wd;
};

// Returns a watcher handle for create/delete/move events in `dir`, or
// nullptr (errno left set) when inotify is unavailable.
GP_API gp_watch* gp_watch_create(const char* dir) {
  int ifd = inotify_init1(IN_NONBLOCK | IN_CLOEXEC);
  if (ifd < 0) return nullptr;
  int wd = inotify_add_watch(
      ifd, dir, IN_CREATE | IN_DELETE | IN_MOVED_TO | IN_MOVED_FROM);
  if (wd < 0) {
    int saved = errno;
    close(ifd);
    errno = saved;
    return nullptr;
  }
  return new gp_watch{ifd, wd};
}

// Blocks up to timeout_ms for a filesystem event in the watched dir.
// Returns 1 if at least one event arrived, 0 on timeout, -errno on error.
// A deleted watch directory delivers IN_IGNORED / IN_DELETE_SELF and then
// goes silent forever; that surfaces as -ESTALE so the caller re-creates
// the watch (or polls) instead of believing it still has one.
GP_API int gp_watch_wait(gp_watch* w, int timeout_ms) {
  if (!w) return -EINVAL;
  struct pollfd pfd = {w->ifd, POLLIN, 0};
  int rc = poll(&pfd, 1, timeout_ms);
  if (rc < 0) return -errno;
  if (rc == 0) return 0;
  // drain the queue, scanning for watch-death events; the caller re-stats
  // the socket regardless, so event payloads are not returned
  char buf[4096] __attribute__((aligned(8)));
  bool stale = false;
  ssize_t n;
  while ((n = read(w->ifd, buf, sizeof buf)) > 0) {
    for (ssize_t off = 0; off + (ssize_t)sizeof(inotify_event) <= n;) {
      const inotify_event* ev =
          reinterpret_cast<const inotify_event*>(buf + off);
      if (ev->mask & (IN_IGNORED | IN_DELETE_SELF | IN_MOVE_SELF | IN_UNMOUNT))
        stale = true;
      off += sizeof(inotify_event) + ev->len;
    }
  }
  return stale ? -ESTALE : 1;
}

GP_API void gp_watch_destroy(gp_watch* w) {
  if (!w) return;
  inotify_rm_watch(w->ifd, w->wd);
  close(w->ifd);
  delete w;
}

// ---------------------------------------------------------------------------
// device-node probe
// ---------------------------------------------------------------------------

// 0 when `path` is a character device, -errno on stat failure, -ENOTSUP
// when the path exists but is not a chardev (fixture trees model device
// nodes as regular files).
//
// Stat-only, never open(2): an open of /dev/nvidia<minor> is what a CUDA
// process does first, and a probe must neither create driver state on a
// GPU a workload owns nor race its launch.  Granular state (AER fatal
// errors, NVML's remapped-row failure) is read by health/server.py.
GP_API int gp_probe_device(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0) return -errno;
  if (!S_ISCHR(st.st_mode)) return -ENOTSUP;
  return 0;
}

// The char-device major of `path` (>= 0), -ENOTSUP when it is not a
// chardev, -errno on stat failure.
GP_API int gp_char_major(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0) return -errno;
  if (!S_ISCHR(st.st_mode)) return -ENOTSUP;
  return static_cast<int>(major(st.st_rdev));
}

// ---------------------------------------------------------------------------
// NUMA lookup
// ---------------------------------------------------------------------------

// NUMA node of a PCI function from its sysfs directory.  Returns the node
// id (>= 0), 0 when the kernel reports -1 (unknown), or -errno.
GP_API int gp_numa_node(const char* pci_sysfs_dir) {
  char path[4096];
  int n = snprintf(path, sizeof path, "%s/numa_node", pci_sysfs_dir);
  if (n < 0 || static_cast<size_t>(n) >= sizeof path) return -ENAMETOOLONG;
  FILE* f = fopen(path, "re");
  if (!f) return -errno;
  int node = -1;
  int rc = fscanf(f, "%d", &node);
  fclose(f);
  if (rc != 1) return -EINVAL;
  return node < 0 ? 0 : node;
}
