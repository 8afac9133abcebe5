"""Split the time of K3-mla's tensor-core body into its phases, on one
NVIDIA GPU.

    python scripts/mla_phase_probe.py

Makes a timed copy of ``csrc/mla_decode.cu`` under
``build/mla_phase_probe/`` (the kernel's code unchanged; ``clock64``
read by thread 0 of block (0, 0, 0) at the edges of its phases, and the
global timer read by every block at its start and end), builds it with
the port's nvcc flags, and launches it at the plans of PLANS (bf16, T
2560, five calls each; the last one read). Prints one JSON line a plan:
``us``, the phase edges in microseconds from the block's start (at the
SM's maximum clock, which nvidia-smi reports: ``loop_start`` the query
fragments issued, ``landed[i]`` tile i has landed, ``scores[i]``,
``softmax[i]``, ``value[i]`` the ends of its phases, for the first six
tiles; ``merge_sync`` the first cluster barrier passed, ``sent`` the
second (every part sent), ``weights`` the cluster's weights made,
``end``), and the blocks' durations from the
global timer (``blocks``: eight spread over the sorted list, then the
longest), the SMs the blocks ran on (``sms``) and how many blocks shared
an SM with another block of their cluster. Then the card's name, power limit and clocks.
Needs a CUDA device and nvcc; imports nothing of JAX. A diagnostic: the
timed copy is never used by the port.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

# (B, H, n_valid, per, n_splits): one position in one block and in 8;
# 16 tiles a block with no merge; the served B 1 and B 2 plans (T 2560,
# length 2559, 132 SMs), the served plan with one head group, and B 1
# cut into 14 and 8 ranges
PLANS = ((1, 16, 1, 1, 1), (1, 128, 1, 1, 1), (1, 128, 512, 512, 1),
         (1, 128, 2560, 160, 16), (1, 16, 2560, 160, 16),
         (2, 128, 2560, 288, 9), (1, 128, 2560, 192, 14),
         (1, 128, 2560, 320, 8))
# the phase edges: (slot, the line of the kernel the reading follows,
# whether it is read once a tile)
EDGES = (("1 + 4 * it", "    mbar_wait(&full[it & 1], (it >> 1) & 1);"
          "  // tile it has landed\n", True),
         ("2 + 4 * it", "          make_float2(c1[2], c1[3]);\n    }\n"
          "    __syncthreads();\n", True),
         ("3 + 4 * it", "        m_s[sh] = m_new;\n      }\n    }\n"
          "    __syncthreads();\n", True),
         ("4 + 4 * it", "    __syncthreads();  // the stage, P and the "
          "partial scores are free\n", True),
         ("31", "    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = "
          "0.f;\n", False),
         ("32", "  __syncthreads();\n  cluster_arrive();\n"
          "  cluster_wait();\n", False),
         ("35", "  cluster_wait();  // every part of this block's share has "
          "arrived\n", False),
         ("33", "    if (has) xw[lane * kHG + h] = c / L;\n  }\n"
          "  __syncthreads();\n", False))
NAMES = {31: "loop_start", 32: "merge_sync", 33: "weights",
         35: "sent"}


def timed_source() -> str:
    """mla_decode.cu with the readings put into its tensor-core body."""
    src = open(os.path.join(ROOT, "src/repro_torch/csrc/mla_decode.cu")
               ).read()
    head, rest = src.split("mla_decode_mma_kernel(", 1)
    body, tail = rest.split("// ---------------------------------------"
                            "---------------------- launches", 1)
    clock = ("if (blockIdx.x == 0 && blockIdx.z == 0 && threadIdx.x == 0)"
             " g_t[{}] = clock64();\n")
    timer = ("  {{ unsigned long long gt; unsigned sm; asm volatile("
             "\"mov.u64 %0, %globaltimer;\" : \"=l\"(gt));\n"
             "    asm volatile(\"mov.u32 %0, %smid;\" : \"=r\"(sm));\n"
             "    if (threadIdx.x == 0) {{ g_b[2 * (blockIdx.z * gridDim.x + "
             "blockIdx.x) + {0}] = gt; g_sm[blockIdx.z * gridDim.x + "
             "blockIdx.x] = sm; }} }}\n")
    start = "  cg::cluster_group cluster = cg::this_cluster();\n"
    assert body.count(start) == 1
    body = body.replace(start, start + timer.format(0) + "  "
                        + clock.format(0))
    for slot, line, per_tile in EDGES:
        assert body.count(line) == 1, line
        body = body.replace(line, line + ("    if (it < 6) " if per_tile
                                          else "  ") + clock.format(slot))
    end = body.rstrip().rfind("}")
    body = (body[:end] + "  " + clock.format(34) + timer.format(1)
            + "}\n\n")
    head = head.replace("namespace {\n", "__device__ unsigned long long "
                        "g_t[64];\n__device__ unsigned long long "
                        "g_b[8192];\n__device__ unsigned g_sm[4096];\n"
                        "namespace {\n", 1)
    return (head + "mla_decode_mma_kernel(" + body
            + "// ------------------------------------------------------"
            "------- launches" + tail + """
extern "C" int probe_read(unsigned long long* t, unsigned long long* b,
                          unsigned* sm) {
  cudaError_t e = cudaMemcpyFromSymbol(t, g_t, sizeof(g_t));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(b, g_b, sizeof(g_b));
  return e != cudaSuccess ? e : cudaMemcpyFromSymbol(sm, g_sm, sizeof(g_sm));
}
""")


def main() -> int:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as DA
    if not torch.cuda.is_available():
        print("mla_phase_probe: no CUDA device", file=sys.stderr)
        return 2
    out = os.path.join(ROOT, "build", "mla_phase_probe")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "mla_probe.cu"), os.path.join(
        out, "libmla_probe.so")
    with open(cu, "w") as f:
        f.write(timed_source())
    r = subprocess.run([_build._nvcc(), *_build.nvcc_flags("mla_decode"),
                        "-I", str(_build.CSRC), "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        print(r.stderr, file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
         "clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=False).stdout.strip()
    mhz = float(smi.split(",")[-1])
    lib = ctypes.CDLL(so)
    fn = lib.mla_decode_attention
    fn.argtypes, fn.restype = DA._MLA_ARGTYPES, ctypes.c_int
    lib.probe_read.argtypes = [ctypes.c_void_p] * 3
    dev = torch.device("cuda")
    for B, H, n_valid, per, n_splits in PLANS:
        gen = torch.Generator(device=dev).manual_seed(0)

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(
                torch.bfloat16)
        q_abs, q_rope = randn(B, 1, H, 512), randn(B, 1, H, 64)
        c_kv, k_rope = randn(B, 2560, 512), randn(B, 2560, 64)
        lat = torch.empty_like(q_abs)
        for _ in range(5):
            _build.launch_check(fn(
                1, 1, q_abs.data_ptr(), q_rope.data_ptr(), c_kv.data_ptr(),
                k_rope.data_ptr(), lat.data_ptr(), B, 2560, H, 512, 64,
                n_valid - 1, per, n_splits, 0.07, _build.stream_of(dev)),
                "mla_phase_probe")
        torch.cuda.synchronize()
        t = (ctypes.c_ulonglong * 64)()
        g = (ctypes.c_ulonglong * 8192)()
        sm = (ctypes.c_uint * 4096)()
        _build.launch_check(lib.probe_read(t, g, sm), "probe_read")
        us = {}
        for i in range(1, 36):
            if t[i] >= t[0] and t[i] - t[0] < 10 ** 9:
                k = (i - 1) // 4
                name = (NAMES.get(i) or ("end" if i == 34 else (
                    "landed", "scores", "softmax", "value")[(i - 1) % 4]
                    + f"[{k}]"))
                us[name] = (t[i] - t[0]) / mhz
        n = B * -(-H // 16) * n_splits
        blocks = sorted((g[2 * i + 1] - g[2 * i]) / 1e3 for i in range(n))
        # blocks of one cluster (grid z) on a shared SM
        groups = n // n_splits
        shared = sum(n_splits - len({sm[z * groups + x]
                                     for z in range(n_splits)})
                     for x in range(groups))
        print(json.dumps(dict(B=B, H=H, n_valid=n_valid, per=per,
                              n_splits=n_splits, us=us,
                              blocks=blocks[::max(1, n // 8)][:8]
                              + [blocks[-1]], sms=len(set(sm[:n])),
                              blocks_doubled_in_cluster=shared)),
              flush=True)
    print(f"card (name, W, MHz now, MHz max): {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
