// Submanifold and strided sparse convolutions of the sparse U-ResNet
// (models/sparse_uresnet.py) as gather-GEMM on the bf16 tensor cores
// (mma.sync m16n8k16, f32 accumulation), over the rulebooks of
// ops/sparse.py. Replaces no TPU kernel: the JAX package has no sparse net;
// these are the convolutions of arXiv:1711.10275 as the sparse U-ResNet of
// arXiv:1903.05663 runs them.
//
// Two kernels, bound in ops/cuda/sparse_conv.py:
//
//   sparse_gemm   out[j] = sum_k [table[k, j] >= 0] x[table[k, j]] W'_k
//                 (+ residual[j]) (+ bias), table (K, n_out) int32 or none
//                 (the identity, K = 1). W'_k is w[k] (C_in x C_out), or for
//                 an input gradient w[k]^T, with the offsets mirrored
//                 (k -> K - 1 - k) for the submanifold convolution. One
//                 block computes 64 output rows x BN channels: for each
//                 offset, the 64 rows' sources are read once (the table is
//                 offset-major, so they are contiguous), an offset none of
//                 the 64 rows has is skipped whole, then 16 input channels
//                 at a time the gathered rows and W'_k's slice go to shared
//                 memory and each of the 4 warps multiplies its 16 rows.
//                 Output-stationary: every output row is written once, by
//                 one block, without atomics.
//   sparse_wgrad  dw[k] += sum_j [table[k, j] >= 0] x[table[k, j]]^T dy[j],
//                 f32, over the forward's table, whose pairs ops/sparse.py
//                 lists offset-major in runs of 32 (a chunk: one offset). A
//                 block takes a share of the chunks and a 64 x BN tile of
//                 (C_in, C_out), so every block has the same work whatever
//                 the offsets' counts, and adds its tile into dw with
//                 atomics when the offset changes (dw is zeroed by the
//                 caller; the sum's order varies from run to run, within
//                 f32 rounding).
//
// What bounds them: at the sparse net's deep levels (10-17 neighbours a
// site, 64-96 channels) the tensor cores; at the shallow ones (1.6-3.4
// neighbours, 16-32 channels) the gathers, bytes and latency. The design
// keeps every operand read once per block from L2 at most, skips empty
// offsets a tile at a time (sites are in Morton order, so a tile is a
// compact block of space and shares its empty offsets), and sizes the
// channel tile to C_out (16, 32, 48, 64 or 96) so that little of the
// product is padding. There is no cp.async pipeline: enough blocks are
// resident (4 warps, < 10 KB of shared memory each) to hide the gathers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBM = 64;        // output rows of a gemm block (16 a warp)
constexpr int kBK = 16;        // input channels a step (the mma's depth)
constexpr int kPad = 8;        // bf16 pad of a shared row: 48-byte rows, no
                               // bank conflict in the fragment reads
constexpr int kWR = 32;        // rows a wgrad step (two mma depths)
constexpr int kWM = 64;        // C_in of a wgrad tile (16 a warp)
constexpr int kWPad = 2;       // bf16 pad of a wgrad shared row: 68-byte
                               // rows spread the transposing stores

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// 8 consecutive channels [c, c + 8) of row `row`, zero beyond `cols`.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ base, int64_t row,
                                       int cols, int c, bool vec) {
    const __nv_bfloat16* p = base + row * cols + c;
    if (vec && c + 8 <= cols) return __ldg(reinterpret_cast<const uint4*>(p));
    union {
        uint4 v;
        __nv_bfloat16 h[8];
    } u;
#pragma unroll
    for (int i = 0; i < 8; ++i) u.h[i] = c + i < cols ? p[i] : __float2bfloat16(0.f);
    return u.v;
}

template <typename OutT>
__device__ __forceinline__ void store2(OutT* p, float a, float b, bool both);

template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b,
                                                      bool both) {
    if (both)
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
    else
        p[0] = __float2bfloat16(a);
}

template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b, bool both) {
    if (both)
        *reinterpret_cast<float2*>(p) = make_float2(a, b);
    else
        p[0] = a;
}

template <int BN, typename OutT>
__global__ void __launch_bounds__(kThreads)
    sparse_gemm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                       const int* __restrict__ table, const __nv_bfloat16* __restrict__ res,
                       const float* __restrict__ bias, OutT* __restrict__ out, int64_t n_out,
                       int cin, int cout, int K, int transpose, int mirror, int vec) {
    __shared__ __align__(16) __nv_bfloat16 As[kBM][kBK + kPad];
    __shared__ __align__(16) __nv_bfloat16 Bs[BN][kBK + kPad];
    __shared__ int src[kBM];

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int64_t row0 = (int64_t)blockIdx.x * kBM;
    const int col0 = blockIdx.y * BN;
    float acc[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    for (int k = 0; k < K; ++k) {
        int has = 0;
        if (tid < kBM) {
            const int64_t r = row0 + tid;
            int s = -1;
            if (r < n_out) s = table ? table[(int64_t)k * n_out + r] : (int)r;
            src[tid] = s;
            has = s >= 0;
        }
        if (!__syncthreads_or(has)) continue;
        const __nv_bfloat16* wk = w + (int64_t)(mirror ? K - 1 - k : k) * cin * cout;
        for (int c0 = 0; c0 < cin; c0 += kBK) {
            {  // A: the 64 gathered rows, 8 channels a thread
                const int r = tid >> 1, h = (tid & 1) * 8;
                const int s = src[r];
                uint4 v = make_uint4(0, 0, 0, 0);
                if (s >= 0) v = load8(x, s, cin, c0 + h, vec);
                *reinterpret_cast<uint4*>(&As[r][h]) = v;
            }
            // B: Bs[n][kk] = W'_k[c0 + kk][col0 + n]
            for (int e = tid; e < BN * kBK; e += kThreads) {
                const int n = e / kBK, kk = e % kBK;
                const int ci = c0 + kk, co = col0 + n;
                __nv_bfloat16 v = __float2bfloat16(0.f);
                if (ci < cin && co < cout)
                    v = wk[transpose ? (int64_t)co * cin + ci : (int64_t)ci * cout + co];
                Bs[n][kk] = v;
            }
            __syncthreads();
            const int ar = warp * 16 + g;
            const uint32_t a[4] = {ld_u32(&As[ar][2 * t]), ld_u32(&As[ar + 8][2 * t]),
                                   ld_u32(&As[ar][2 * t + 8]), ld_u32(&As[ar + 8][2 * t + 8])};
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
                ptx::mma_bf16_16816(acc[j], a, ld_u32(&Bs[j * 8 + g][2 * t]),
                                    ld_u32(&Bs[j * 8 + g][2 * t + 8]));
            __syncthreads();
        }
    }
    // epilogue: + residual, + bias, one rounding to OutT
    const bool pairs = (cout & 1) == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
        const int c = col0 + j * 8 + 2 * t;
        if (c >= cout) continue;
        const bool both = pairs && c + 1 < cout;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int64_t r = row0 + warp * 16 + g + half * 8;
            if (r >= n_out) continue;
            float v0 = acc[j][2 * half], v1 = acc[j][2 * half + 1];
            if (res) {
                v0 += __bfloat162float(res[r * cout + c]);
                if (c + 1 < cout) v1 += __bfloat162float(res[r * cout + c + 1]);
            }
            if (bias) {
                v0 += bias[c];
                if (c + 1 < cout) v1 += bias[c + 1];
            }
            if (both || c + 1 >= cout) {
                store2(out + r * cout + c, v0, v1, both);
            } else {  // odd C_out: two single stores
                store2(out + r * cout + c, v0, 0.f, false);
                store2(out + r * cout + c + 1, v1, 0.f, false);
            }
        }
    }
}

// dw[k] += a wgrad block's tile (its warp's 16 rows of C_in x BN), then
// the tile is zeroed.
template <int BN>
__device__ __forceinline__ void flush_tile(float (&acc)[BN / 8][4], float* __restrict__ dw,
                                           int k, int ci0, int co0, int cin, int cout) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    float* dwk = dw + (int64_t)k * cin * cout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int ci = ci0 + warp * 16 + g + (i >> 1) * 8;
            const int co = co0 + j * 8 + 2 * t + (i & 1);
            if (ci < cin && co < cout && acc[j][i] != 0.f)
                atomicAdd(dwk + (int64_t)ci * cout + co, acc[j][i]);
            acc[j][i] = 0.f;
        }
    }
}

// dw (K, cin, cout) f32 += the block's tile. The rows with a source at
// offset k are listed offset-major in `pairs`, each offset's run padded to
// a multiple of kWR with -1, so each run of kWR entries (a chunk) has one
// offset, chunk_k[chunk]; without `pairs` (the identity, K = 1) chunk c is
// rows [c kWR, (c + 1) kWR). A block takes `per` consecutive chunks and
// one tile of (cin / kWM) x (cout / BN) (grid: (chunk shares, tiles)), and
// adds its sum into dw whenever the offset changes and at its end.
template <int BN>
__global__ void __launch_bounds__(kThreads)
    sparse_wgrad_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                        const int* __restrict__ table, const int* __restrict__ pairs,
                        const int* __restrict__ chunk_k, float* __restrict__ dw,
                        int64_t n_rows, int64_t n_chunks, int per, int cin, int cout,
                        int vec_x, int vec_dy) {
    __shared__ __align__(16) __nv_bfloat16 Xs[kWM][kWR + kWPad];  // (ci, pair)
    __shared__ __align__(16) __nv_bfloat16 Ds[BN][kWR + kWPad];   // (co, pair)
    __shared__ int src[kWR];
    __shared__ int dst[kWR];

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int n_tiles = (cout + BN - 1) / BN;
    const int ci0 = (blockIdx.y / n_tiles) * kWM, co0 = (blockIdx.y % n_tiles) * BN;
    float acc[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    const int64_t c_begin = (int64_t)blockIdx.x * per;
    const int64_t c_end = min(c_begin + per, n_chunks);
    int cur = -1;
    for (int64_t ch = c_begin; ch < c_end; ++ch) {
        const int k = pairs ? chunk_k[ch] : 0;
        if (k != cur) {
            if (cur >= 0) flush_tile<BN>(acc, dw, cur, ci0, co0, cin, cout);
            cur = k;
        }
        if (tid < kWR) {
            const int64_t e = ch * kWR + tid;
            int j = -1, s = -1;
            if (pairs) {
                j = pairs[e];
                if (j >= 0) s = table[(int64_t)k * n_rows + j];
            } else if (e < n_rows) {
                j = s = (int)e;
            }
            src[tid] = s;
            dst[tid] = j;
        }
        __syncthreads();
        // Xs[ci][p] = x[src[p]][ci0 + ci]: a thread takes 8 channels of a pair
        for (int e = tid; e < kWR * (kWM / 8); e += kThreads) {
            const int p = e / (kWM / 8), c = (e % (kWM / 8)) * 8;
            const int s = src[p];
            union {
                uint4 v;
                __nv_bfloat16 h[8];
            } u;
            u.v = make_uint4(0, 0, 0, 0);
            if (s >= 0 && ci0 + c < cin) u.v = load8(x, s, cin, ci0 + c, vec_x);
#pragma unroll
            for (int i = 0; i < 8; ++i) Xs[c + i][p] = u.h[i];
        }
        // Ds[co][p] = dy[dst[p]][co0 + co]
        for (int e = tid; e < kWR * (BN / 8); e += kThreads) {
            const int p = e / (BN / 8), c = (e % (BN / 8)) * 8;
            const int j = dst[p];
            union {
                uint4 v;
                __nv_bfloat16 h[8];
            } u;
            u.v = make_uint4(0, 0, 0, 0);
            if (j >= 0 && co0 + c < cout) u.v = load8(dy, j, cout, co0 + c, vec_dy);
#pragma unroll
            for (int i = 0; i < 8; ++i) Ds[c + i][p] = u.h[i];
        }
        __syncthreads();
        const int ar = warp * 16 + g;
#pragma unroll
        for (int kk = 0; kk < kWR; kk += 16) {
            const uint32_t a[4] = {ld_u32(&Xs[ar][kk + 2 * t]), ld_u32(&Xs[ar + 8][kk + 2 * t]),
                                   ld_u32(&Xs[ar][kk + 2 * t + 8]),
                                   ld_u32(&Xs[ar + 8][kk + 2 * t + 8])};
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
                ptx::mma_bf16_16816(acc[j], a, ld_u32(&Ds[j * 8 + g][kk + 2 * t]),
                                    ld_u32(&Ds[j * 8 + g][kk + 2 * t + 8]));
        }
        __syncthreads();
    }
    if (cur >= 0) flush_tile<BN>(acc, dw, cur, ci0, co0, cin, cout);
}

// -- the pipelined kernels: channels a multiple of 8 ------------------------
//
// The same two products, for operands whose rows are whole 16-byte chunks
// (every conv of the sparse net but the stem's input and the head's three
// classes, which take the kernels above). A gemm block loads its 64 rows'
// sources of every offset at once, lists the offsets any of them has,
// and runs its (offset, 32 input channels) steps through a 3-stage
// cp.async ring: the gathered rows (zero-filled where a row has no
// source) and W'_k's slice land in shared memory while the tensor cores
// work on the step before; the fragments come by ldmatrix (transposed
// for W'_k's (C_in, C_out) rows). A wgrad block runs its chunks of 32
// pairs through the same ring, both operands row-major as they are read
// and transposed by ldmatrix.

constexpr int kStages = 3;
constexpr int kKC = 32;       // input channels (gemm) or pairs (wgrad) a step
constexpr int kMaxK = 27;     // offsets of a 3^3 kernel

template <int BN, typename OutT, int TRANS>
__global__ void __launch_bounds__(kThreads)
    sparse_gemm_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                          const int* __restrict__ table, const __nv_bfloat16* __restrict__ res,
                          const float* __restrict__ bias, OutT* __restrict__ out, int64_t n_out,
                          int cin, int cout, int K, int mirror) {
    // B: TRANS ? (n, k) rows : (k, n) rows
    constexpr int kBRows = TRANS ? BN : kKC;
    constexpr int kBCols = (TRANS ? kKC : BN) + 8;
    __shared__ __align__(16) __nv_bfloat16 As[kStages][kBM][kKC + 8];
    __shared__ __align__(16) __nv_bfloat16 Bs[kStages][kBRows][kBCols];
    __shared__ int tab[kMaxK][kBM];
    __shared__ int act[kMaxK];
    __shared__ int n_act;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int64_t row0 = (int64_t)blockIdx.x * kBM;
    const int col0 = blockIdx.y * BN;
    for (int e = tid; e < K * kBM; e += kThreads) {
        const int k = e / kBM, r = e % kBM;
        const int64_t row = row0 + r;
        tab[k][r] = row < n_out ? (table ? table[(int64_t)k * n_out + row] : (int)row) : -1;
    }
    __syncthreads();
    for (int k = warp; k < K; k += kThreads / 32) {
        const bool any = __any_sync(0xffffffffu, tab[k][lane] >= 0 || tab[k][lane + 32] >= 0);
        if (lane == 0) act[k] = any;
    }
    __syncthreads();
    if (tid == 0) {
        int n = 0;
        for (int k = 0; k < K; ++k)
            if (act[k]) act[n++] = k;
        n_act = n;
    }
    __syncthreads();
    const int chunks = (cin + kKC - 1) / kKC;
    const int steps = n_act * chunks;

    auto load = [&](int step, int stage) {
        const int k = act[step / chunks], c0 = (step % chunks) * kKC;
        // A: 64 rows x 4 chunks of 8 channels
        for (int e = tid; e < kBM * (kKC / 8); e += kThreads) {
            const int r = e / (kKC / 8), c = c0 + (e % (kKC / 8)) * 8;
            const int s = tab[k][r];
            const bool ok = s >= 0 && c < cin;
            ptx::cp_async16(ptx::smem_addr(&As[stage][r][c - c0]),
                            ok ? x + (int64_t)s * cin + c : x, ok);
        }
        const __nv_bfloat16* wk = w + (int64_t)(mirror ? K - 1 - k : k) * cin * cout;
        for (int e = tid; e < kBRows * ((kBCols - 8) / 8); e += kThreads) {
            const int r = e / ((kBCols - 8) / 8), q = (e % ((kBCols - 8) / 8)) * 8;
            // TRANS: row r is output channel col0 + r, q input channels
            // from c0; else row r is input channel c0 + r, q output
            // channels from col0
            const int ci = TRANS ? c0 + q : c0 + r, co = TRANS ? col0 + r : col0 + q;
            const bool ok = ci < cin && co < cout;
            const __nv_bfloat16* src =
                TRANS ? wk + (int64_t)co * cin + ci : wk + (int64_t)ci * cout + co;
            ptx::cp_async16(ptx::smem_addr(&Bs[stage][r][q]), ok ? src : w, ok);
        }
    };

    float acc[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
        if (i < steps) load(i, i);
        ptx::cp_async_commit();
    }
    for (int step = 0; step < steps; ++step) {
        const int stage = step % kStages;
        ptx::cp_async_wait<kStages - 2>();
        __syncthreads();
        // refill the stage the previous step used
        if (step + kStages - 1 < steps) load(step + kStages - 1, (step + kStages - 1) % kStages);
        ptx::cp_async_commit();
#pragma unroll
        for (int kk = 0; kk < kKC; kk += 16) {
            uint32_t a[4];
            const int m = lane >> 3;
            ptx::ldsm_x4(a, ptx::smem_addr(
                                &As[stage][warp * 16 + (m & 1) * 8 + (lane & 7)][kk + (m >> 1) * 8]));
#pragma unroll
            for (int j = 0; j < BN / 8; j += 2) {
                uint32_t b[4];
                if (TRANS)
                    ptx::ldsm_x4(b, ptx::smem_addr(
                                        &Bs[stage][(j + (m >> 1)) * 8 + (lane & 7)][kk + (m & 1) * 8]));
                else
                    ptx::ldsm_x4_trans(b, ptx::smem_addr(
                                              &Bs[stage][kk + (m & 1) * 8 + (lane & 7)][(j + (m >> 1)) * 8]));
                ptx::mma_bf16_16816(acc[j], a, b[0], b[1]);
                ptx::mma_bf16_16816(acc[j + 1], a, b[2], b[3]);
            }
        }
    }
    ptx::cp_async_wait<0>();
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
        const int c = col0 + j * 8 + 2 * t;
        if (c >= cout) continue;  // cout is a multiple of 8: c + 1 < cout
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int64_t r = row0 + warp * 16 + g + half * 8;
            if (r >= n_out) continue;
            float v0 = acc[j][2 * half], v1 = acc[j][2 * half + 1];
            if (res) {
                const __nv_bfloat162 rv =
                    *reinterpret_cast<const __nv_bfloat162*>(res + r * cout + c);
                v0 += __low2float(rv);
                v1 += __high2float(rv);
            }
            if (bias) {
                v0 += bias[c];
                v1 += bias[c + 1];
            }
            store2(out + r * cout + c, v0, v1, true);
        }
    }
}

template <int BN>
__global__ void __launch_bounds__(kThreads)
    sparse_wgrad_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                           const int* __restrict__ table, const int* __restrict__ pairs,
                           const int* __restrict__ chunk_k, float* __restrict__ dw,
                           int64_t n_rows, int64_t n_chunks, int per, int cin, int cout) {
    __shared__ __align__(16) __nv_bfloat16 Xs[kStages][kKC][kWM + 8];  // (pair, ci)
    __shared__ __align__(16) __nv_bfloat16 Ds[kStages][kKC][BN + 8];   // (pair, co)

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int n_tiles = (cout + BN - 1) / BN;
    const int ci0 = (blockIdx.y / n_tiles) * kWM, co0 = (blockIdx.y % n_tiles) * BN;
    const int64_t c_begin = (int64_t)blockIdx.x * per;
    const int steps = (int)(min(c_begin + per, n_chunks) - c_begin);

    auto load = [&](int step, int stage) {
        const int64_t ch = c_begin + step;
        const int k = pairs ? chunk_k[ch] : 0;
        for (int e = tid; e < kKC * (kWM / 8); e += kThreads) {
            const int p = e / (kWM / 8), c = ci0 + (e % (kWM / 8)) * 8;
            const int64_t i = ch * kKC + p;
            int j = -1, s = -1;
            if (pairs) {
                j = pairs[i];
                if (j >= 0) s = table[(int64_t)k * n_rows + j];
            } else if (i < n_rows) {
                s = (int)i;
            }
            const bool ok = s >= 0 && c < cin;
            ptx::cp_async16(ptx::smem_addr(&Xs[stage][p][c - ci0]),
                            ok ? x + (int64_t)s * cin + c : x, ok);
        }
        for (int e = tid; e < kKC * (BN / 8); e += kThreads) {
            const int p = e / (BN / 8), c = co0 + (e % (BN / 8)) * 8;
            const int64_t i = ch * kKC + p;
            const int j = pairs ? pairs[i] : (i < n_rows ? (int)i : -1);
            const bool ok = j >= 0 && c < cout;
            ptx::cp_async16(ptx::smem_addr(&Ds[stage][p][c - co0]),
                            ok ? dy + (int64_t)j * cout + c : dy, ok);
        }
    };

    float acc[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
        if (i < steps) load(i, i);
        ptx::cp_async_commit();
    }
    int cur = -1;
    for (int step = 0; step < steps; ++step) {
        const int stage = step % kStages;
        const int k = pairs ? chunk_k[c_begin + step] : 0;
        if (k != cur) {
            if (cur >= 0) flush_tile<BN>(acc, dw, cur, ci0, co0, cin, cout);
            cur = k;
        }
        ptx::cp_async_wait<kStages - 2>();
        __syncthreads();
        if (step + kStages - 1 < steps) load(step + kStages - 1, (step + kStages - 1) % kStages);
        ptx::cp_async_commit();
        const int m = lane >> 3;
#pragma unroll
        for (int kk = 0; kk < kKC; kk += 16) {
            // A = x^T (ci x pair) from Xs (pair, ci); B = dy (pair x co)
            uint32_t a[4];
            ptx::ldsm_x4_trans(a, ptx::smem_addr(
                                      &Xs[stage][kk + (m >> 1) * 8 + (lane & 7)][warp * 16 + (m & 1) * 8]));
#pragma unroll
            for (int j = 0; j < BN / 8; j += 2) {
                uint32_t b[4];
                ptx::ldsm_x4_trans(b, ptx::smem_addr(
                                          &Ds[stage][kk + (m & 1) * 8 + (lane & 7)][(j + (m >> 1)) * 8]));
                ptx::mma_bf16_16816(acc[j], a, b[0], b[1]);
                ptx::mma_bf16_16816(acc[j + 1], a, b[2], b[3]);
            }
        }
    }
    ptx::cp_async_wait<0>();
    if (cur >= 0) flush_tile<BN>(acc, dw, cur, ci0, co0, cin, cout);
}

template <int BN>
cudaError_t launch_gemm(int out_f32, const void* x, const void* w, const void* table,
                        const void* res, const void* bias, void* out, int64_t n_out, int cin,
                        int cout, int K, int transpose, int mirror, int vec,
                        cudaStream_t stream) {
    const dim3 grid((unsigned)((n_out + kBM - 1) / kBM), (cout + BN - 1) / BN);
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    const auto* tb = static_cast<const int*>(table);
    const auto* rb = static_cast<const __nv_bfloat16*>(res);
    const auto* bb = static_cast<const float*>(bias);
    // vec: x, w, res and out are 16-byte aligned (ops/cuda/sparse_conv.py)
    const bool tc = vec && cin % 8 == 0 && cout % 8 == 0 && K <= kMaxK;
#define TC(OUT, TR)                                                                       \
    sparse_gemm_tc_kernel<BN, OUT, TR><<<grid, kThreads, 0, stream>>>(                    \
        xb, wb, tb, rb, bb, static_cast<OUT*>(out), n_out, cin, cout, K, mirror)
    if (tc && out_f32 && transpose)
        TC(float, 1);
    else if (tc && out_f32)
        TC(float, 0);
    else if (tc && transpose)
        TC(__nv_bfloat16, 1);
    else if (tc)
        TC(__nv_bfloat16, 0);
#undef TC
    else if (out_f32)
        sparse_gemm_kernel<BN, float><<<grid, kThreads, 0, stream>>>(
            xb, wb, tb, rb, bb, static_cast<float*>(out), n_out, cin, cout, K, transpose, mirror,
            vec);
    else
        sparse_gemm_kernel<BN, __nv_bfloat16><<<grid, kThreads, 0, stream>>>(
            xb, wb, tb, rb, bb, static_cast<__nv_bfloat16*>(out), n_out, cin, cout, K, transpose,
            mirror, vec);
    return cudaGetLastError();
}

template <int BN>
cudaError_t launch_wgrad(const void* x, const void* dy, const void* table, const void* pairs,
                         const void* chunk_k, void* dw, int64_t n_rows, int64_t n_chunks,
                         int per, int cin, int cout, int vec_x, int vec_dy,
                         cudaStream_t stream) {
    const int tiles = ((cin + kWM - 1) / kWM) * ((cout + BN - 1) / BN);
    const dim3 grid((unsigned)((n_chunks + per - 1) / per), tiles);
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* db = static_cast<const __nv_bfloat16*>(dy);
    const auto* tb = static_cast<const int*>(table);
    const auto* pb = static_cast<const int*>(pairs);
    const auto* kb = static_cast<const int*>(chunk_k);
    if (vec_x && vec_dy && cin % 8 == 0 && cout % 8 == 0)
        sparse_wgrad_tc_kernel<BN><<<grid, kThreads, 0, stream>>>(
            xb, db, tb, pb, kb, static_cast<float*>(dw), n_rows, n_chunks, per, cin, cout);
    else
        sparse_wgrad_kernel<BN><<<grid, kThreads, 0, stream>>>(
            xb, db, tb, pb, kb, static_cast<float*>(dw), n_rows, n_chunks, per, cin, cout,
            vec_x, vec_dy);
    return cudaGetLastError();
}

}  // namespace

// bn: the channel tile (16, 32, 48, 64 or 96; ops/cuda/sparse_conv.py
// `tile`); out_f32: write f32, else bf16. Returns the launch's CUDA error.
extern "C" int uresnet_sparse_gemm(int bn, int out_f32, const void* x, const void* w,
                                   const void* table, const void* res, const void* bias,
                                   void* out, int64_t n_out, int cin, int cout, int K,
                                   int transpose, int mirror, int vec, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
#define GEMM(BN)                                                                              \
    case BN:                                                                                  \
        return launch_gemm<BN>(out_f32, x, w, table, res, bias, out, n_out, cin, cout, K,     \
                               transpose, mirror, vec, s);
    switch (bn) {
        GEMM(16)
        GEMM(32)
        GEMM(48)
        GEMM(64)
        GEMM(96)
        default:
            return cudaErrorInvalidValue;
    }
#undef GEMM
}

extern "C" int uresnet_sparse_wgrad(int bn, const void* x, const void* dy, const void* table,
                                    const void* pairs, const void* chunk_k, void* dw,
                                    int64_t n_rows, int64_t n_chunks, int per, int cin, int cout,
                                    int vec_x, int vec_dy, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
#define WGRAD(BN)                                                                         \
    case BN:                                                                              \
        return launch_wgrad<BN>(x, dy, table, pairs, chunk_k, dw, n_rows, n_chunks, per,  \
                                cin, cout, vec_x, vec_dy, s);
    switch (bn) {
        WGRAD(16)
        WGRAD(32)
        WGRAD(48)
        WGRAD(64)
        WGRAD(96)
        default:
            return cudaErrorInvalidValue;
    }
#undef WGRAD
}
