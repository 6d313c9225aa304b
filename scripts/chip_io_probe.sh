#!/usr/bin/env bash
# A GPU machine at a glance: free disk, cores, memory, the card, the
# toolchain, and its I/O rates (1 GiB written with fsync and read back,
# zlib.crc32 over it, device-to-host copies pageable and pinned).
# Run it on the GPU machine from the repository's root:
#     bash scripts/chip_io_probe.sh
set -x
df -h / /tmp . "${TMPDIR:-/tmp}" 2>&1
echo TMPDIR=$TMPDIR HOME=$HOME
nproc; free -g
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
which g++ gcc; g++ --version | head -1
python - <<'PY'
import os, time, tempfile, zlib, numpy as np, torch
d = tempfile.mkdtemp()
print("tmpdir", d)
a = np.random.default_rng(0).integers(0, 255, 1 << 30, dtype=np.uint8)  # 1 GiB
for i in range(2):
    p = os.path.join(d, f"f{i}.bin")
    t0 = time.perf_counter()
    with open(p, "wb") as f:
        f.write(memoryview(a))
        f.flush(); os.fsync(f.fileno())
    t1 = time.perf_counter()
    print(f"write+fsync 1GiB {t1-t0:.3f}s")
    t0 = time.perf_counter(); c = zlib.crc32(memoryview(a)); t1 = time.perf_counter()
    print(f"zlib.crc32 1GiB {t1-t0:.3f}s")
    t0 = time.perf_counter()
    with open(p, "rb") as f:
        b = f.read()
    print(f"read 1GiB {time.perf_counter()-t0:.3f}s")
x = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
for pin in (False, True):
    t0 = time.perf_counter(); h = torch.empty(1 << 30, dtype=torch.uint8, pin_memory=pin); t1 = time.perf_counter()
    h.copy_(x); torch.cuda.synchronize(); t2 = time.perf_counter()
    h.copy_(x); torch.cuda.synchronize(); t3 = time.perf_counter()
    print(f"pin={pin} alloc {t1-t0:.3f}s d2h {t2-t1:.3f}s again {t3-t2:.3f}s")
import shutil
shutil.rmtree(d)
PY
