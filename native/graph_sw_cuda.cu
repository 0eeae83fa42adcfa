// Paired multi-event graph Smith-Waterman fill for NVIDIA Hopper (sm_90a),
// called from JAX through the XLA foreign function interface.
//
// Same tables in and the same [4, B] block out as the plain-JAX fill
// (paragraph_tpu/ops/multi_sw.py xla_fill), which is this kernel's
// reference: score, event-local end column (global index), end read row,
// and the multi-node-top-score flag, bit-identical.
//
// Layout: one warp per read lane. A lane holds R = M / 32 consecutive read
// rows of the DP column in registers, so the diagonal shift is an
// in-register shift plus one __shfl_up_sync, and the closed-form F column
// (a prefix max along the read axis) is a per-lane running max followed by
// a 5-step warp scan. Hopper's DPX instructions fuse the recurrence's
// add-max (__viaddmax_s32) and three-way max (__vimax3_s32).
//
// The per-node boundary columns (H and E of each node's last column, the
// predecessor seeds) and the per-node maxima live in device memory
// scratch that XLA allocates as extra results; they are touched once per
// node, not once per column. Blocks are independent: each warp owns one
// read lane and all of its scratch.
//
// Build: make -C native cuda

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int32_t kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

struct FillParams {
  int B, N, P, M, TB;
  int gap_open, gap_extend, match, mismatch;
  int col_bits, j_bits;
};

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = max(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

template <int R>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
paired_fill_kernel(const int32_t* __restrict__ packed_cols,
                   const int32_t* __restrict__ pred_tables,  // [E, N, P]
                   const int32_t* __restrict__ tile_col_start,
                   const int32_t* __restrict__ tile_col_len,
                   const int32_t* __restrict__ tile_event,
                   const int8_t* __restrict__ codes,  // [B, M]
                   const int32_t* __restrict__ lens,
                   const int32_t* __restrict__ vlens,
                   int32_t* __restrict__ out,        // [4, B]
                   int32_t* __restrict__ saved,      // [B, N, 2, M]
                   int32_t* __restrict__ node_max,   // [B, N]
                   FillParams p) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  if (b >= p.B) return;  // uniform per warp
  const int t = b / p.TB;
  const int ev = tile_event[t];
  const int c0 = tile_col_start[t];
  const int clen = tile_col_len[t];
  const int len = lens[b];
  const int vlen = vlens[b];
  const int M = p.M;
  const int N = p.N;
  const int s1 = p.col_bits + p.j_bits;
  const int lmask = (1 << p.col_bits) - 1;
  const int jmask = (1 << p.j_bits) - 1;
  const int gapE = p.gap_extend;
  const int gOE = p.gap_open - p.gap_extend;
  const int row0 = lane * R;

  int code[R], mism[R], jterm[R], gterm2[R], jgap[R], real[R];
  int h[R], e[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = row0 + r;
    code[r] = codes[(size_t)b * M + j];
    mism[r] = code[r] < 4 ? -p.mismatch : 0;
    // packed end-tracking row code; rows past the stripe never win
    jterm[r] = j < vlen ? jmask - j : -kBig;
    jgap[r] = j * gapE;
    gterm2[r] = jgap[r] + gapE - p.gap_open;
    real[r] = j < len ? -1 : 0;
    h[r] = 0;
    e[r] = 0;
  }

  int32_t* my_saved = saved + (size_t)b * N * 2 * M;
  int32_t* my_nmax = node_max + (size_t)b * N;
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      my_saved[(2 * n) * M + row0 + r] = 0;
      my_saved[(2 * n + 1) * M + row0 + r] = 0;
    }
  }
  if (lane == 0) {
    for (int n = 0; n < N; ++n) my_nmax[n] = 0;
  }

  const int32_t* ev_pred = pred_tables + (size_t)ev * N * p.P;
  int best = 0;
  int nodecol = 0;

  for (int k = 0; k < clen; ++k) {
    const int pc = __ldg(packed_cols + c0 + k);
    const int ref_c = pc & 7;
    const int nid = (pc >> 3) & 0xFFF;

    if (pc & (1 << 15)) {
      // node start: seed H/E with the elementwise max over predecessor
      // boundary columns; slot N is the all-zero state
      int sh[R], se[R];
      const int q0 = __ldg(ev_pred + nid * p.P);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        sh[r] = q0 < N ? my_saved[(2 * q0) * M + row0 + r] : 0;
        se[r] = q0 < N ? my_saved[(2 * q0 + 1) * M + row0 + r] : 0;
      }
      for (int q = 1; q < p.P; ++q) {
        const int qn = __ldg(ev_pred + nid * p.P + q);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          sh[r] = max(sh[r], qn < N ? my_saved[(2 * qn) * M + row0 + r] : 0);
          se[r] = max(se[r],
                      qn < N ? my_saved[(2 * qn + 1) * M + row0 + r] : 0);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        h[r] = sh[r];
        e[r] = se[r];
      }
      nodecol = 0;
    }

    // profile row for this column's reference class; class 4 (N/pad)
    // scores 0 against every read base
    const int rc = ref_c < 4 ? ref_c : -1;
    const int mm_mask = ref_c < 4 ? -1 : 0;

    int up = __shfl_up_sync(kFull, h[R - 1], 1);
    if (lane == 0) up = 0;
    int hp[R], pre[R];
    int run = -kBig;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int diag = r ? h[r - 1] : up;
      const int prof = code[r] == rc ? p.match : (mism[r] & mm_mask);
      hp[r] = __vimax3_s32(diag + prof, 0, e[r]);
      run = __viaddmax_s32(hp[r], gterm2[r], run);
      pre[r] = run;
    }
    // warp-inclusive prefix max of the lane totals, then shift by one lane
    int tot = run;
#pragma unroll
    for (int s = 1; s < kWarp; s <<= 1) {
      const int o = __shfl_up_sync(kFull, tot, s);
      if (lane >= s) tot = max(tot, o);
    }
    int excl = __shfl_up_sync(kFull, tot, 1);
    if (lane == 0) excl = -kBig;

    int colbest = -kBig;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int gprev = r ? max(excl, pre[r - 1]) : excl;
      const int f = max(gprev - jgap[r], 0);
      const int hv = max(hp[r], f);
      h[r] = hv;
      e[r] = __viaddmax_s32(hv, -gOE, e[r]) - gapE;
      colbest = __viaddmax_s32(hv << s1, jterm[r], colbest);
      nodecol = max(nodecol, hv & real[r]);
    }
    best = max(best, colbest + ((lmask - k) << p.j_bits));

    if (pc & (1 << 16)) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        my_saved[(2 * nid) * M + row0 + r] = h[r];
        my_saved[(2 * nid + 1) * M + row0 + r] = e[r];
      }
      const int nm = warp_max(nodecol);
      if (lane == 0) my_nmax[nid] = nm;
    }
  }

  best = warp_max(best);
  if (lane == 0) {
    const int cur_max = best >> s1;
    const int end_col = c0 + (lmask - ((best >> p.j_bits) & lmask));
    const int first_j = jmask - (best & jmask);
    int n_top = 0;
    for (int n = 0; n < N; ++n) n_top += my_nmax[n] == cur_max;
    const bool zero = cur_max == 0;
    out[b] = cur_max;
    out[p.B + b] = zero ? -1 : end_col;
    out[2 * p.B + b] = zero ? 0 : min(first_j, len - 1);
    out[3 * p.B + b] = n_top > 1;
  }
}

template <int R>
void launch(cudaStream_t stream, const int32_t* packed_cols,
            const int32_t* pred_tables, const int32_t* tcs,
            const int32_t* tcl, const int32_t* tev, const int8_t* codes,
            const int32_t* lens, const int32_t* vlens, int32_t* out,
            int32_t* saved, int32_t* node_max, const FillParams& p) {
  const int blocks = (p.B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  paired_fill_kernel<R><<<blocks, kWarp * kWarpsPerBlock, 0, stream>>>(
      packed_cols, pred_tables, tcs, tcl, tev, codes, lens, vlens, out, saved,
      node_max, p);
}

ffi::Error PairedFillImpl(
    cudaStream_t stream, ffi::Buffer<ffi::S32> packed_cols,
    ffi::Buffer<ffi::S32> pred_tables, ffi::Buffer<ffi::S32> tile_col_start,
    ffi::Buffer<ffi::S32> tile_col_len, ffi::Buffer<ffi::S32> tile_event,
    ffi::Buffer<ffi::S8> codes, ffi::Buffer<ffi::S32> lens,
    ffi::Buffer<ffi::S32> vlens, int32_t n_nodes, int32_t n_preds,
    int32_t tile_batch, int32_t gap_open, int32_t gap_extend, int32_t match,
    int32_t mismatch, int32_t col_bits, int32_t j_bits,
    ffi::ResultBuffer<ffi::S32> out, ffi::ResultBuffer<ffi::S32> saved,
    ffi::ResultBuffer<ffi::S32> node_max) {
  auto cdims = codes.dimensions();
  if (cdims.size() != 2) return ffi::Error::InvalidArgument("codes: [B, M]");
  FillParams p;
  p.B = static_cast<int>(cdims[0]);
  p.M = static_cast<int>(cdims[1]);
  p.N = n_nodes;
  p.P = n_preds;
  p.TB = tile_batch;
  p.gap_open = gap_open;
  p.gap_extend = gap_extend;
  p.match = match;
  p.mismatch = mismatch;
  p.col_bits = col_bits;
  p.j_bits = j_bits;
  if (p.M % kWarp != 0 || p.M > 8 * kWarp)
    return ffi::Error::InvalidArgument("M must be a multiple of 32, <= 256");
  if (p.TB <= 0 || p.B % p.TB != 0)
    return ffi::Error::InvalidArgument("B must be a multiple of TB");
  if (p.N >= (1 << 12))
    return ffi::Error::InvalidArgument("node ids take 12 bits");

  const int32_t* a0 = packed_cols.typed_data();
  const int32_t* a1 = pred_tables.typed_data();
  const int32_t* a2 = tile_col_start.typed_data();
  const int32_t* a3 = tile_col_len.typed_data();
  const int32_t* a4 = tile_event.typed_data();
  const int8_t* a5 = codes.typed_data();
  const int32_t* a6 = lens.typed_data();
  const int32_t* a7 = vlens.typed_data();
  int32_t* o0 = out->typed_data();
  int32_t* o1 = saved->typed_data();
  int32_t* o2 = node_max->typed_data();
  switch (p.M / kWarp) {
    case 1: launch<1>(stream, a0, a1, a2, a3, a4, a5, a6, a7, o0, o1, o2, p); break;
    case 2: launch<2>(stream, a0, a1, a2, a3, a4, a5, a6, a7, o0, o1, o2, p); break;
    case 3: launch<3>(stream, a0, a1, a2, a3, a4, a5, a6, a7, o0, o1, o2, p); break;
    case 4: launch<4>(stream, a0, a1, a2, a3, a4, a5, a6, a7, o0, o1, o2, p); break;
    case 5: launch<5>(stream, a0, a1, a2, a3, a4, a5, a6, a7, o0, o1, o2, p); break;
    case 6: launch<6>(stream, a0, a1, a2, a3, a4, a5, a6, a7, o0, o1, o2, p); break;
    case 7: launch<7>(stream, a0, a1, a2, a3, a4, a5, a6, a7, o0, o1, o2, p); break;
    case 8: launch<8>(stream, a0, a1, a2, a3, a4, a5, a6, a7, o0, o1, o2, p); break;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    ParagraphPairedFill, PairedFillImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S32>>()  // packed_cols
        .Arg<ffi::Buffer<ffi::S32>>()  // pred_tables
        .Arg<ffi::Buffer<ffi::S32>>()  // tile_col_start
        .Arg<ffi::Buffer<ffi::S32>>()  // tile_col_len
        .Arg<ffi::Buffer<ffi::S32>>()  // tile_event
        .Arg<ffi::Buffer<ffi::S8>>()   // codes [B, M]
        .Arg<ffi::Buffer<ffi::S32>>()  // lens
        .Arg<ffi::Buffer<ffi::S32>>()  // vlens
        .Attr<int32_t>("n_nodes")
        .Attr<int32_t>("n_preds")
        .Attr<int32_t>("tile_batch")
        .Attr<int32_t>("gap_open")
        .Attr<int32_t>("gap_extend")
        .Attr<int32_t>("match")
        .Attr<int32_t>("mismatch")
        .Attr<int32_t>("col_bits")
        .Attr<int32_t>("j_bits")
        .Ret<ffi::Buffer<ffi::S32>>()   // out [4, B]
        .Ret<ffi::Buffer<ffi::S32>>()   // scratch: boundary columns
        .Ret<ffi::Buffer<ffi::S32>>()); // scratch: per-node maxima
