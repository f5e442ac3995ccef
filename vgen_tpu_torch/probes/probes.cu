// The three probe kernels, for the measurement tools of
// vgen_tpu_torch/probes (never launched by a scan).  They replace the
// TPU probes of scripts/ that ask what an instruction or a primitive
// costs:
//
// - probe_primitive<kPrim>: scripts/roofline.py:162 (make, body _body,
//   feedback _feedback): R dependent repetitions of one production
//   primitive of csrc/ per lane;
// - probe_issue<kOp, kChains>: scripts/microbench_vpu.py:66 (make): R
//   repetitions of one instruction in kChains dependent chains per lane;
// - probe_fieldmul<kMode>: scripts/microbench_fieldmul.py:120 (make): R
//   repetitions of one part of the field multiply or one hash.
//
// The TPU probes timed (16, 8, 512) VMEM tiles of 16-bit limbs and
// one-hot matmuls; here a lane is one thread on 32-bit limbs, the layout
// of kernels A to I, and the DFA step is a table load.  Each kernel is
// bound by its repetitions' operations (the loads and stores are two
// (8, N) reads and one write), which is what it measures.  Built into
// its own library (csrc/build.py unit "probes"), so the product's units
// do not grow.
#include <cuda_runtime.h>

#include "probe_lanes.cuh"

namespace {

using namespace vg;
using namespace vg::probe;

constexpr int kBlock = 128;

template <int kPrim>
__global__ void probe_primitive(const uint32_t* a_in, const uint32_t* b_in,
                                const int32_t* table, uint32_t* out, long n,
                                int reps) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t a[8], b[8], r[8];
  fe_load(a, a_in, n, e);
  fe_load(b, b_in, n, e);
  primitive_lane<kPrim>(r, a, b, table, reps);
  fe_store(out, n, e, r);
}

template <int kOp, int kChains>
__global__ void probe_issue(const uint32_t* a_in, const uint32_t* b_in,
                            uint32_t* out, long n, int reps) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t a[8], b[8], r[8];
  fe_load(a, a_in, n, e);
  fe_load(b, b_in, n, e);
  issue_lane<kOp, kChains>(r, a, b, reps);
  fe_store(out, n, e, r);
}

template <int kMode>
__global__ void probe_fieldmul(const uint32_t* a_in, const uint32_t* b_in,
                               uint32_t* out, long n, int reps) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t a[8], b[8], r[8];
  fe_load(a, a_in, n, e);
  fe_load(b, b_in, n, e);
  fieldmul_lane<kMode>(r, a, b, reps);
  fe_store(out, n, e, r);
}

unsigned blocks(long n) { return (unsigned)((n + kBlock - 1) / kBlock); }

template <int kPrim>
int launch_primitive(int prim, const uint32_t* a, const uint32_t* b,
                     const int32_t* table, uint32_t* out, long n, int reps,
                     cudaStream_t stream) {
  if constexpr (kPrim == kNumPrimitives) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (prim != kPrim)
      return launch_primitive<kPrim + 1>(prim, a, b, table, out, n, reps,
                                         stream);
    probe_primitive<kPrim><<<blocks(n), kBlock, 0, stream>>>(a, b, table, out,
                                                             n, reps);
    return (int)cudaGetLastError();
  }
}

template <int kOp, int kChains>
int launch_issue_chains(int chains, const uint32_t* a, const uint32_t* b,
                        uint32_t* out, long n, int reps, cudaStream_t stream) {
  if constexpr (kChains > 8) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (chains != kChains)
      return launch_issue_chains<kOp, 2 * kChains>(chains, a, b, out, n, reps,
                                                   stream);
    probe_issue<kOp, kChains><<<blocks(n), kBlock, 0, stream>>>(a, b, out, n,
                                                                reps);
    return (int)cudaGetLastError();
  }
}

template <int kOp>
int launch_issue(int op, int chains, const uint32_t* a, const uint32_t* b,
                 uint32_t* out, long n, int reps, cudaStream_t stream) {
  if constexpr (kOp == kNumIssueOps) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (op != kOp)
      return launch_issue<kOp + 1>(op, chains, a, b, out, n, reps, stream);
    return launch_issue_chains<kOp, 1>(chains, a, b, out, n, reps, stream);
  }
}

template <int kMode>
int launch_fieldmul(int mode, const uint32_t* a, const uint32_t* b,
                    uint32_t* out, long n, int reps, cudaStream_t stream) {
  if constexpr (kMode == kNumFieldMulModes) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (mode != kMode)
      return launch_fieldmul<kMode + 1>(mode, a, b, out, n, reps, stream);
    probe_fieldmul<kMode><<<blocks(n), kBlock, 0, stream>>>(a, b, out, n,
                                                            reps);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// C entry points: a, b, out (8, n) uint32 limb-major on the card; the
// DFA table (64, W) int32 (read by the dfachar instances only).  Each
// launches on the caller's stream and returns cudaGetLastError().
extern "C" {

int vgen_probe_primitive(int prim, const void* a, const void* b,
                         const void* table, void* out, int n, int reps,
                         void* stream) {
  return launch_primitive<0>(prim, (const uint32_t*)a, (const uint32_t*)b,
                             (const int32_t*)table, (uint32_t*)out, n, reps,
                             (cudaStream_t)stream);
}

int vgen_probe_issue(int op, int chains, const void* a, const void* b,
                     void* out, int n, int reps, void* stream) {
  return launch_issue<0>(op, chains, (const uint32_t*)a, (const uint32_t*)b,
                         (uint32_t*)out, n, reps, (cudaStream_t)stream);
}

int vgen_probe_fieldmul(int mode, const void* a, const void* b, void* out,
                        int n, int reps, void* stream) {
  return launch_fieldmul<0>(mode, (const uint32_t*)a, (const uint32_t*)b,
                            (uint32_t*)out, n, reps, (cudaStream_t)stream);
}

}  // extern "C"
