"""Host-interface bindings of the node agents: ``gpuprobe``, the ctypes
binding of the port's ``csrc/gpuprobe.cpp`` shim (inotify watch,
stat-only device-node probe, NUMA read).  Policy lives in Python, kernel
interfaces in the shim; callers that cannot load it fall back to
portable Python."""
