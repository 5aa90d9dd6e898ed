// Fused multi-tick Chained-Raft window for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel josefine_tpu/ops/pallas_step.py `_kernel`
// (:394, tick body `_tile_step` :110): `ticks` lockstep cluster ticks for
// every group, with the state and the in-flight inbox read from device
// memory once and written once per window, and the five window metrics
// reduced per warp.
//
// What bounds it on this card: the integer ALU pipe. Device memory is
// touched twice per window (about 3 KB per group at N = 5); each node-tick
// is a chain of several hundred compares, selects and logic ops (at N = 5
// some 540 on the shortest path through the tick loop, 820 with every part
// taken; chip_smoke.py counts them in the SASS). At 500 ticks per window the
// bytes are under 1% of the operation bound. A warp holds leaders and
// followers side by side, so it runs both roles' parts of the body every
// tick: what the ALU pipe executes lies between those two counts. The
// design therefore spends nothing on memory and everything on issuing fewer
// instructions and keeping enough warps resident to cover the chain's
// latency.
//
// Mapping. A warp holds G = 32 / N whole groups, one lane per (group, node):
// 6 groups on 30 lanes at N = 5, 2 on 32 at N = 16. No group crosses a warp,
// so delivery, next_inbox[dst][src] = out[src][dst], is warp-local. Each
// warp owns a double-buffered mailbox in shared memory, laid out
// [9 fields][G * N dst lanes][N srcs] per buffer (5.4 KB at N = 5). In tick
// t a node reads each src's message from buffer t % 2 as its fold reaches
// that src, and writes each message it sends (replies as it forms them,
// then broadcasts over them) into column `me` of its group in the other
// buffer. One __syncwarp per tick orders the writes before the next tick's
// reads; the double buffer makes that enough, since a write of tick t + 1
// lands in the buffer read in tick t, which every lane has left at the
// sync. (Single buffering would need a second sync per tick; double
// buffering costs 10.8 KB per warp, 173 KB for 16 resident warps, which the
// SM has.) There is no block-wide barrier anywhere in the kernel, so a block
// is only a bundle of independent warps: `warps_per_block` packs warps onto
// SMs and changes nothing else. Idle lanes (30, 31 at N = 5) and the groups
// past P in the ragged last warp skip the tick but take part in the sync.
//
// Registers. Nothing of the inbox or outbox lives in registers, only the
// node's state: 13 scalars, the ballot as an N-bit mask, and the match and
// nxt rows (4N). Membership, quorum and the peer mask are fixed for the
// window and computed once (Group). The step params are read from device
// memory at the start, so a launch needs no copy to the host.
// __launch_bounds__ caps N <= 8 at 128 registers; at N = 5 ptxas uses about
// 110, with no local memory, for 16 resident warps per SM (the register
// file's four quarters each hold four such warps).
//
// The quorum commit ranks the members' match ids with one compare per pair,
// N(N-1)/2, where counting each id's support compared all N² pairs.
// Block-id compares stay (t, s) pairs of 32-bit compares: packing them into
// order-preserving 64-bit keys (two ISETP per compare) gave more
// instructions in the tick loop, not fewer. Counted by chip_smoke.py's
// tick_loop_sass at N = 5 on NVIDIA H100 80GB HBM3, 700.00 W: 541 ALU / 759
// issued per node-tick on the shortest path for the keys, 537 / 757 for the
// pairs.
#include <cuda_runtime.h>

#include "fused_step.cuh"

namespace josefine {

constexpr int MAX_THREADS = 256;  // warps_per_block <= 8

template <int N>
__host__ __device__ constexpr int mailbox_ints_per_warp() {
  return 2 * N_INBOX * groups_per_warp<N>() * N * N;  // two buffers
}

template <int N>
__global__ void __launch_bounds__(MAX_THREADS, N <= 8 ? 2 : 1)
fused_window_kernel(WindowArgs a) {
  extern __shared__ int smem[];
  constexpr int G = groups_per_warp<N>();
  constexpr int BOX = N_INBOX * MailRow<N>::FS;  // one buffer
  constexpr int WARP_INTS = mailbox_ints_per_warp<N>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long wg = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (wg * G >= a.num_parts) return;  // a whole warp past the end
  const int g = lane / N, me = lane % N;
  const long long p = wg * G + g;
  const bool active = (g < G) & (p < a.num_parts);
  int* cur = smem + warp * WARP_INTS;
  int* nxt = cur + BOX;
  const int row = (g * N + me) * N;  // my inbox row within a buffer
  const int col = g * N * N + me;    // my outbox column within a buffer

  const Params P = load_params<N>(a);
  Node<N> st;
  Group grp;
  int props = 0;
  int met[N_METRICS] = {0, 0, 0, 0, 0};
  if (active) {
    load_node<N>(a, p, me, st, grp, props);
    load_inbox<N>(a, p, me, cur + row);
  }
  __syncwarp();
#pragma unroll 1
  for (int t = 0; t < a.ticks; ++t) {
    if (active) node_tick<N>(P, grp, me, props, st, MailRow<N>{cur + row, nxt + col}, met);
    __syncwarp();
    int* const tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (active) {
    store_node<N>(a, p, me, st);
    store_inbox<N>(a, p, me, cur + row);
  }

  // Warp reduction of the window metrics (wrapping int32, like the host).
#pragma unroll
  for (int k = 0; k < N_METRICS; ++k) {
    const int v = __reduce_add_sync(0xffffffffu, met[k]);
    if (lane == 0) a.partials[wg * N_METRICS + k] = v;
  }
}

template <int N>
size_t smem_bytes(int warps_per_block) {
  return (size_t)warps_per_block * mailbox_ints_per_warp<N>() * sizeof(int);
}

template <int N>
cudaError_t set_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fused_window_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int N>
cudaError_t launch(const WindowArgs& a, int warps_per_block, cudaStream_t stream) {
  if (warps_per_block < 1 || warps_per_block * 32 > MAX_THREADS) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<N>(warps_per_block);
  cudaError_t e = set_smem<N>(smem);
  if (e != cudaSuccess) return e;
  const long long warps = (a.num_parts + groups_per_warp<N>() - 1) / groups_per_warp<N>();
  const long long blocks = (warps + warps_per_block - 1) / warps_per_block;
  if (blocks > 0)
    fused_window_kernel<N><<<(unsigned)blocks, warps_per_block * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// out: registers/thread, max threads/block, local bytes/thread, dynamic
// shared bytes/block, resident blocks/SM (the occupancy calculator, at this
// block shape).
template <int N>
cudaError_t info(int warps_per_block, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fused_window_kernel<N>);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes<N>(warps_per_block);
  e = set_smem<N>(smem);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fused_window_kernel<N>,
                                                    warps_per_block * 32, smem);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = attr.maxThreadsPerBlock;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)smem;
  out[4] = blocks;
  return cudaSuccess;
}

}  // namespace josefine

#define JF_SWITCH_N(n, CALL)                                              \
  switch (n) {                                                            \
    case 1: return CALL(1); case 2: return CALL(2);                       \
    case 3: return CALL(3); case 4: return CALL(4);                       \
    case 5: return CALL(5); case 6: return CALL(6);                       \
    case 7: return CALL(7); case 8: return CALL(8);                       \
    case 9: return CALL(9); case 10: return CALL(10);                     \
    case 11: return CALL(11); case 12: return CALL(12);                   \
    case 13: return CALL(13); case 14: return CALL(14);                   \
    case 15: return CALL(15); case 16: return CALL(16);                   \
    default: return (int)cudaErrorInvalidValue;                           \
  }

extern "C" {

// Run one window on `stream`, `warps_per_block` warps of 32 / n groups to a
// block. `params` (a host array) holds the device pointers of the 5 step
// params; `peer_fresh` is a device pointer to n int32 flags, or null;
// `in_leaves` / `out_leaves` (host arrays) hold the 18 state then 9 inbox
// device pointers. Returns the cudaError_t of the launch.
int josefine_fused_window(int n, long long num_parts, int ticks, int warps_per_block,
                          const void* const* params, const void* peer_fresh,
                          const void* const* in_leaves, void* const* out_leaves,
                          const void* member, const void* props, void* partials,
                          void* stream) {
  const josefine::WindowArgs a = josefine::make_args(num_parts, ticks, params, peer_fresh,
                                                     in_leaves, out_leaves, member, props,
                                                     partials);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define JF_LAUNCH(K) (int)josefine::launch<K>(a, warps_per_block, s)
  JF_SWITCH_N(n, JF_LAUNCH)
#undef JF_LAUNCH
}

// The compiled kernel's resources for group size n at `warps_per_block`
// (see josefine::info for the five ints written to `out`).
int josefine_fused_kernel_info(int n, int warps_per_block, int* out) {
#define JF_INFO(K) (int)josefine::info<K>(warps_per_block, out)
  JF_SWITCH_N(n, JF_INFO)
#undef JF_INFO
}

const char* josefine_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
