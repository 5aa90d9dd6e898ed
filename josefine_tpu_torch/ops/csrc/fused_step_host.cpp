// Host emulation of the fused-window kernel, built with g++ from the same
// tick body (fused_step.cuh) so the CPU test suite can hold the hand-written
// body against the JAX package without a card.
//
// It emulates the kernel's warps one after another: 32 lanes, G = 32 / N
// whole groups on the first G * N of them, the rest idle, and the groups
// past P in the ragged last warp idle too. Each warp has the kernel's
// double-buffered mailbox, with the same layout and the same MailRow
// offsets; a tick runs node_tick<N> for every active lane and then swaps the
// buffers, which is what the kernel's __syncwarp orders. Lanes touch
// disjoint mailbox slots, so running them in turn gives the kernel's result.
// Metrics land in the kernel's (ceil(P / G), 5) per-warp partials layout.
#include <vector>

#include "fused_step.cuh"

namespace josefine {

template <int N>
int run_host(const WindowArgs& a) {
  constexpr int G = groups_per_warp<N>();
  constexpr int BOX = N_INBOX * MailRow<N>::FS;
  const long long warps = (a.num_parts + G - 1) / G;
  const Params P = load_params<N>(a);
  std::vector<int> mail(2 * BOX);
  std::vector<Node<N>> st(32);
  for (long long wg = 0; wg < warps; ++wg) {
    Group grp[32];
    int props[32];
    bool active[32];
    int met[32][N_METRICS] = {};
    int* cur = mail.data();
    int* nxt = cur + BOX;
    for (int lane = 0; lane < 32; ++lane) {
      const int g = lane / N, me = lane % N;
      const long long p = wg * G + g;
      active[lane] = g < G && p < a.num_parts;
      if (!active[lane]) continue;
      load_node<N>(a, p, me, st[lane], grp[lane], props[lane]);
      load_inbox<N>(a, p, me, cur + (g * N + me) * N);
    }
    for (int t = 0; t < a.ticks; ++t) {
      for (int lane = 0; lane < 32; ++lane) {
        if (!active[lane]) continue;
        const int g = lane / N, me = lane % N;
        const MailRow<N> box{cur + (g * N + me) * N, nxt + g * N * N + me};
        node_tick<N>(P, grp[lane], me, props[lane], st[lane], box, met[lane]);
      }
      int* const tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    for (int k = 0; k < N_METRICS; ++k) a.partials[wg * N_METRICS + k] = 0;
    for (int lane = 0; lane < 32; ++lane) {
      if (!active[lane]) continue;
      const int g = lane / N, me = lane % N;
      store_node<N>(a, wg * G + g, me, st[lane]);
      store_inbox<N>(a, wg * G + g, me, cur + (g * N + me) * N);
      for (int k = 0; k < N_METRICS; ++k)
        a.partials[wg * N_METRICS + k] = wadd(a.partials[wg * N_METRICS + k], met[lane][k]);
    }
  }
  return 0;
}

}  // namespace josefine

extern "C" {

// The host twin of josefine_fused_window (no stream; warps_per_block only
// packs warps onto SMs, so it has no effect here). Returns 0, or -1 for a
// group size outside 1..16.
int josefine_fused_window_host(int n, long long num_parts, int ticks, int warps_per_block,
                               const void* const* params, const void* peer_fresh,
                               const void* const* in_leaves, void* const* out_leaves,
                               const void* member, const void* props, void* partials) {
  (void)warps_per_block;
  const josefine::WindowArgs a = josefine::make_args(num_parts, ticks, params, peer_fresh,
                                                     in_leaves, out_leaves, member, props,
                                                     partials);
  switch (n) {
    case 1: return josefine::run_host<1>(a);
    case 2: return josefine::run_host<2>(a);
    case 3: return josefine::run_host<3>(a);
    case 4: return josefine::run_host<4>(a);
    case 5: return josefine::run_host<5>(a);
    case 6: return josefine::run_host<6>(a);
    case 7: return josefine::run_host<7>(a);
    case 8: return josefine::run_host<8>(a);
    case 9: return josefine::run_host<9>(a);
    case 10: return josefine::run_host<10>(a);
    case 11: return josefine::run_host<11>(a);
    case 12: return josefine::run_host<12>(a);
    case 13: return josefine::run_host<13>(a);
    case 14: return josefine::run_host<14>(a);
    case 15: return josefine::run_host<15>(a);
    case 16: return josefine::run_host<16>(a);
    default: return -1;
  }
}

}  // extern "C"
