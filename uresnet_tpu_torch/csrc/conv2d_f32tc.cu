// Fused 3x3 conv + per-channel affine (+ residual) (+ ReLU), NHWC, f32, on
// Hopper's tensor cores with the 3xTF32 split.
//
//   y = relu?( conv3x3_SAME(x, w) * scale + bias [+ residual] )
//
// Replaces, for f32 operands, the Pallas kernel fused_conv3x3_bn_relu_v2
// (uresnet_tpu/ops/pallas/conv2d.py:130; v1 at :182 computes the same
// function and is bound to the same entry). Contract: x (B,H,W,C),
// w (3,3,C,Co), residual (B,H,W,Co), scale and bias (Co,), all f32, any
// C >= 1 and Co >= 1, every pointer 16-byte aligned; f32 accumulation, the
// epilogue in f32, one f32 store.
//
// Accuracy. A TF32 operand keeps 11 significant bits, so one TF32 product
// per term (1xTF32) leaves a relative error of ~2^-11 per operand: ~3e-4
// of the output's max at K = 9*C = 144-4608, where true f32 reads ~5e-7.
// The 3xTF32 split keeps f32 accuracy: each operand a becomes hi = tf32(a)
// (round to nearest) and lo = tf32(a - hi), where a - hi is exact in f32,
// and a*b = hi_a*hi_b + hi_a*lo_b + lo_a*hi_b + lo_a*lo_b. The last term
// (~2^-22 relative) and lo's own rounding (~2^-22) are dropped; the three
// MMAs run smallest first into an f32 accumulator that is never rounded to
// TF32. One more trap: the tensor cores add into their f32 accumulator
// with truncation, not round-to-nearest, so the error grows with the
// number of MMAs that update one accumulator -- 3*K/8 of them, which broke
// the 1e-5 limit below at C = 256 on an H100. So the MMAs sum one chunk (9
// taps x 8 channels, 27 updates) into a partial accumulator that starts at
// zero, and each chunk's partial sum is added to the running sum by an
// ordinary f32 add, which rounds to nearest (the remedy of Ootomo and
// Yokota, "Recovering single precision accuracy from Tensor Cores while
// surpassing the FP32 theoretical peak performance", 2022). Measured
// against float64 it then matches true f32 (chip_smoke.py phase 3 holds it
// at 1e-5 of the max, which 1xTF32 fails).
//
// What bounds it on an H100 SXM (495 TFLOP/s TF32 dense, 3.35 TB/s): a
// 3x3 conv does 18*C*Co FLOP per pixel, 3x that on the tensor cores, and
// moves 4*(C + Co [+ Co]) bytes. At the flagship's f32 forward the 512^2
// levels (C, Co <= 32) are byte-bound, 256^2 sits at the ridge, 128^2 and
// below are bound by the tensor cores' operations. On the card TF32
// mma.sync levels off far below TF32 wgmma (PERF.md), so the
// operation-bound calls want wgmma.
//
// Two kernels, both implicit GEMMs: M = a tile's output pixels, N = its
// output channels, K = 9*C walked as 8-channel chunks x 9 taps; both split
// and flush as above, and stage the (TH+2) x (TW+2) x 8 input halo per
// chunk by 16-byte cp.async whose src-size 0 zero-fills outside the image
// (that is the SAME padding: no padded copy of x), a halo pixel's 32 bytes
// as two 16-byte units XOR-swizzled so every 8x8 ldmatrix read is free of
// bank conflicts. ldmatrix.x4 moves 16-bit units, and an 8x8 b16 matrix is
// 8 pixels x 4 f32 channels -- exactly the m16n8k8 TF32 A fragment, which
// is also a warp's share of wgmma's 64x8 A. A tap's A rows are the halo
// shifted by (ky, kx): one row address per lane, so the shift is free.
// The split rounds with an integer add and mask (ptx.cuh tf32_rna:
// cvt.rna.tf32.f32's rounding at the integer pipe's rate).
//
// 1. conv3x3_f32tc_ws_kernel, Co a multiple of 32 (every call from 256^2
//    down): warp-specialised on wgmma m64nNk8, N = 64 or 32 (see below).
// 2. conv3x3_f32tc_kernel, the other multiples of 8 (the 512^2 level: 16
//    output channels), on mma.sync m16n8k8, the bf16 kernel's (conv2d.cu)
//    tiling carried to f32. On an H100 it beat the wgmma kernel below
//    instantiated at N = 16, at the f32 forward's 512^2 calls, and at N = 8
//    (PERF.md, Findings, the f32 kernel): wgmma's per-tap A loads and split
//    stay while its MMA work shrinks with N.
//    * A 2-stage cp.async ring; chunk k+1 loads while chunk k's MMAs run.
//      The weights keep their (3,3,C,Co) layout: per chunk, 9*8 rows of
//      CO_T f32 with a row pitch of 8 (mod 16) words. ldmatrix.trans
//      cannot transpose f32, so B fragments (b0 = W[k=t4][n=g], b1 =
//      W[k=t4+4][n=g]) are 32-bit shared loads; the padded pitch puts a
//      warp's 4x8 reads in 32 distinct banks.
//    * The split in registers after each fragment load (splitting each
//      staged element once, into a second shared plane, measured slower:
//      PERF.md, Findings).
//    * A block covers 16 output channels (8 where Co is an odd multiple
//      of 8): at 16 all of Co, so x is read from HBM once. 8x32-pixel
//      tiles; persistent blocks, as many as fit on the card, walk their
//      tiles with one cp.async ring across tile boundaries, so the next
//      tile's halo and residual load while this tile computes and stores.
//    * Epilogue: scale, bias, residual and ReLU in f32 on the accumulator
//      fragments into a shared output tile (rows padded so the fragment
//      stores are conflict-free), then 16-byte coalesced f32 stores.
//    * Channel tails (C or Co not a multiple of 8): the RAGGED form, a
//      compile-time flag, so the aligned instantiations keep their code;
//      16- or 48-channel tiles (below). ceil(C/8) chunks, the last one's halo channels
//      >= C and weight rows >= C zero-filled -- both operands, since a
//      stale value left in a ring slot can be inf or NaN and 0 * inf is
//      NaN; ceil(Co/16) channel tiles, weight columns, scale, bias and
//      residual channels >= Co read as zero and stores >= Co masked. A
//      zero splits into zero hi and lo, so the accuracy argument above
//      holds unchanged. Rows that start on a 16-byte boundary (C or Co a
//      multiple of 4) load by 16-byte cp.async, zero-filled past the end;
//      others by 4-byte cp.async.ca (f32 is 4-byte aligned at any C), so
//      they stay in the ring's pipeline.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {
namespace f32tc {

constexpr int CK = 8;  // input channels per pipeline stage: the MMA's K

// f32 words per shared-memory row of n channels (weights and output tile):
// a pitch of 8 (mod 16) words puts the rows t4 = 0..3 of a B-fragment read,
// or the rows g = 0..3 of a fragment store, in four distinct 8-bank groups.
constexpr int pitch_words(int n) { return n % 16 == 8 ? n : n + 8; }

// 16-byte unit u (0 or 1) of halo pixel q, XOR-swizzled so that any 8
// consecutive pixels read at one unit fall in 8 distinct 16-byte bank groups.
__device__ __forceinline__ int x_off(int q, int u) { return (q * 2 + (u ^ ((q >> 2) & 1))) * 16; }

// One 16-byte unit of a row, elements [0, n) from `src`, zero from n on,
// into shared memory at `dst`. `vec`: the row starts on a 16-byte
// boundary, so the unit is whole (n >= 4) or past the end (n <= 0): one
// 16-byte cp.async. Else four 4-byte ones. A copy past the end reads
// nothing (src-size 0) from `any`, a valid address.
__device__ __forceinline__ void stage_unit(uint32_t dst, const float* src, const float* any,
                                           int n, bool vec) {
    if (vec) {
        ptx::cp_async16(dst, n > 0 ? src : any, n > 0);
        return;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) ptx::cp_async4(dst + 4 * e, e < n ? src + e : any, e < n);
}

template <int TH, int TW, int CO_T, int STAGES>
struct Shape {
    static constexpr int M = TH * TW;  // pixels per tile
    static constexpr int HALO_W = TW + 2;
    static constexpr int HALO_PX = (TH + 2) * HALO_W;
    static constexpr int HALO_BYTES = HALO_PX * CK * 4;
    static constexpr int WP = pitch_words(CO_T);  // words per staged weight row
    static constexpr int W_BYTES = 9 * CK * WP * 4;
    // a ring slot: halo, then weights
    static constexpr int W_OFF = HALO_BYTES;
    static constexpr int STAGE_BYTES = HALO_BYTES + W_BYTES;
    static constexpr int RING = STAGES * STAGE_BYTES;
    static constexpr int TILE_PITCH = pitch_words(CO_T) * 4;  // bytes per output pixel
    static constexpr int TILE_BYTES = M * TILE_PITCH;
    // STAGES tiles after the ring, each holding its residual (prefetched)
    // and then its output
    static constexpr int SMEM = RING + STAGES * TILE_BYTES;
};

// One tile = TH x TW output pixels x CO_T channels of one image; a block
// walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... RAGGED: any C and Co
// (the channel tails above); without it C and Co are multiples of 8 and of
// CO_T.
template <int TH, int TW, int CO_T, int WM, int WN, int STAGES, int MINB, bool RAGGED>
__global__ void __launch_bounds__(WM * WN * 32, MINB)
conv3x3_f32tc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     const float* __restrict__ res, float* __restrict__ out, int H, int W,
                     int C, int Co, int tiles_w, int tiles_hw, int n_co_tiles, int n_tiles,
                     int relu) {
    using S = Shape<TH, TW, CO_T, STAGES>;
    constexpr int NT = WM * WN * 32;
    constexpr int WARP_M = S::M / WM, WARP_N = CO_T / WN;
    constexpr int MI = WARP_M / 16, NI = WARP_N / 8;
    constexpr int PB = CO_T / 4;  // 16-byte units per weight row and per output pixel
    static_assert(WARP_M % 16 == 0 && WARP_N % 8 == 0, "warp tile");
    static_assert(TW % 8 == 0, "an 8-row ldmatrix group stays in one tile row");

    unsigned char* smem = ptx::dyn_smem();
    const uint32_t sbase = ptx::smem_addr(smem);

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int wm = warp % WM, wn = warp / WM;
    // RAGGED: whether x's and the Co-wide rows (w, residual, out) start on
    // 16-byte boundaries
    const bool x_vec = C % 4 == 0, o_vec = Co % 4 == 0;

    struct Tile {
        int h0, w0, co0, b;
    };
    auto tile_at = [&](int k) {
        const int t = blockIdx.x + k * gridDim.x;
        const int r = t / n_co_tiles, sp = r % tiles_hw;
        return Tile{(sp / tiles_w) * TH, (sp % tiles_w) * TW, (t % n_co_tiles) * CO_T,
                    r / tiles_hw};
    };
    const int n_chunks = RAGGED ? (C + CK - 1) / CK : C / CK;
    const int n_items = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x *
                        n_chunks;  // (tile, chunk) pairs of this block

    // Stage item i (chunk i % n_chunks of tile i / n_chunks) into ring slot
    // `slot`: the halo, zero outside the image, then the 9 taps' CK x CO_T
    // weights; a tile's first item also brings its residual.
    auto load_item = [&](int i, int slot) {
        const int k = i / n_chunks, c0 = (i % n_chunks) * CK;
        const Tile tl = tile_at(k);
        const float* xb = x + (size_t)tl.b * H * W * C;
        const uint32_t hs = sbase + slot * S::STAGE_BYTES;
        for (int j = tid; j < S::HALO_PX * 2; j += NT) {
            const int q = j >> 1, u = j & 1;
            const int gh = tl.h0 - 1 + q / S::HALO_W, gw = tl.w0 - 1 + q % S::HALO_W;
            const bool in = (unsigned)gh < (unsigned)H && (unsigned)gw < (unsigned)W;
            const float* src = in ? xb + ((size_t)gh * W + gw) * C + c0 + u * 4 : x;
            if constexpr (RAGGED)
                stage_unit(hs + x_off(q, u), src, x, in ? C - (c0 + u * 4) : 0, x_vec);
            else
                ptx::cp_async16(hs + x_off(q, u), src, in);
        }
        const uint32_t ws = hs + S::W_OFF;
        for (int j = tid; j < 9 * CK * PB; j += NT) {
            const int r = j / PB, u = j % PB;  // r = tap * CK + k
            const float* src = w + ((size_t)(r / CK) * C + c0 + r % CK) * Co + tl.co0 + u * 4;
            if constexpr (RAGGED)
                stage_unit(ws + (r * S::WP + u * 4) * 4, src, w,
                           c0 + r % CK < C ? Co - (tl.co0 + u * 4) : 0, o_vec);
            else
                ptx::cp_async16(ws + (r * S::WP + u * 4) * 4, src, true);
        }
        if (c0 == 0 && res != nullptr) {
            const uint32_t ts = sbase + S::RING + (k % STAGES) * S::TILE_BYTES;
            for (int j = tid; j < S::M * PB; j += NT) {
                const int m = j / PB, u = j % PB;
                const int oh = tl.h0 + m / TW, ow = tl.w0 + m % TW;
                const bool in = oh < H && ow < W;
                const float* src =
                    in ? res + (((size_t)tl.b * H + oh) * W + ow) * Co + tl.co0 + u * 4 : res;
                if constexpr (RAGGED)
                    stage_unit(ts + m * S::TILE_PITCH + u * 16, src, res,
                               in ? Co - (tl.co0 + u * 4) : 0, o_vec);
                else
                    ptx::cp_async16(ts + m * S::TILE_PITCH + u * 16, src, in);
            }
        }
    };

    // This lane's ldmatrix rows: pixel m of m16 tile mi, 16-byte unit a_u
    // (channels 0-3 or 4-7). Fragment coordinates: row g, column t4.
    int a_q[MI];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
        const int m = wm * WARP_M + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        a_q[mi] = (m / TW) * S::HALO_W + m % TW;
    }
    const int a_u = lane >> 4;
    const int g = lane >> 2, t4 = lane & 3;

    // acc: the running sum over chunks; part: this chunk's, summed by the
    // MMAs from zero and added into acc with round-to-nearest
    float acc[MI][NI][4], part[MI][NI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = part[mi][ni][e] = 0.f;

    // Tile k is summed. The epilogue in f32 on the fragments: scale, bias,
    // residual, ReLU into the shared output tile; then 16-byte coalesced
    // stores of the tile's pixels inside the image (and its channels below
    // Co).
    auto epilogue = [&](int k, unsigned char* tile) {
        const Tile tl = tile_at(k);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
            const int n = wn * WARP_N + ni * 8 + 2 * t4;
            float2 sc, bi;
            if constexpr (RAGGED) {  // channels >= Co: zero
                const int co = tl.co0 + n;
                sc = make_float2(co < Co ? scale[co] : 0.f, co + 1 < Co ? scale[co + 1] : 0.f);
                bi = make_float2(co < Co ? bias[co] : 0.f, co + 1 < Co ? bias[co + 1] : 0.f);
            } else {
                sc = *reinterpret_cast<const float2*>(scale + tl.co0 + n);
                bi = *reinterpret_cast<const float2*>(bias + tl.co0 + n);
            }
#pragma unroll
            for (int mi = 0; mi < MI; ++mi)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int m = wm * WARP_M + mi * 16 + g + 8 * h;
                    float2 y = make_float2(fmaf(acc[mi][ni][2 * h], sc.x, bi.x),
                                           fmaf(acc[mi][ni][2 * h + 1], sc.y, bi.y));
                    float2* cell = reinterpret_cast<float2*>(tile + m * S::TILE_PITCH + n * 4);
                    if (res != nullptr) {  // prefetched into the tile
                        const float2 rv = *cell;
                        y.x += rv.x;
                        y.y += rv.y;
                    }
                    if (relu) {
                        y.x = fmaxf(y.x, 0.f);
                        y.y = fmaxf(y.y, 0.f);
                    }
                    *cell = y;
                    acc[mi][ni][2 * h] = acc[mi][ni][2 * h + 1] = 0.f;
                }
        }
        __syncthreads();
        for (int j = tid; j < S::M * PB; j += NT) {
            const int m = j / PB, u = j % PB;
            const int oh = tl.h0 + m / TW, ow = tl.w0 + m % TW;
            if (oh >= H || ow >= W) continue;
            float* dst = out + (((size_t)tl.b * H + oh) * W + ow) * Co + tl.co0 + u * 4;
            const float* cell = reinterpret_cast<const float*>(tile + m * S::TILE_PITCH + u * 16);
            const int n = Co - (tl.co0 + u * 4);  // channels of this unit below Co
            if (!RAGGED || (o_vec && n > 0))
                *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(cell);
            else if (!o_vec)  // a row that is not 16-byte aligned: element by element
                for (int e = 0; e < 4 && e < n; ++e) dst[e] = cell[e];
        }
    };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < n_items) load_item(s, s);
        ptx::cp_async_commit();
    }
    for (int i = 0; i < n_items; ++i) {
        ptx::cp_async_wait<STAGES - 2>();  // item i has landed (this thread's part)
        __syncthreads();                   // ... everyone's; slot (i-1) % STAGES is free
        if (i + STAGES - 1 < n_items) load_item(i + STAGES - 1, (i + STAGES - 1) % STAGES);
        ptx::cp_async_commit();

        const uint32_t hs = sbase + (i % STAGES) * S::STAGE_BYTES;
        const float* wsp =
            reinterpret_cast<const float*>(smem + (i % STAGES) * S::STAGE_BYTES + S::W_OFF);
#pragma unroll 1
        for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) {
                const int shift = ky * S::HALO_W + kx;
                const int tap = ky * 3 + kx;
                uint32_t ahi[MI][4], alo[MI][4], bhi[NI][2], blo[NI][2];
#pragma unroll
                for (int mi = 0; mi < MI; ++mi) {
                    const uint32_t addr = hs + x_off(a_q[mi] + shift, a_u);
                    ptx::ldsm_x4(ahi[mi], addr);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float a = __uint_as_float(ahi[mi][e]);
                        ahi[mi][e] = ptx::tf32_rna(a);
                        alo[mi][e] = ptx::tf32_rna(a - __uint_as_float(ahi[mi][e]));
                    }
                }
#pragma unroll
                for (int ni = 0; ni < NI; ++ni) {
                    const float* wr = wsp + (tap * CK + t4) * S::WP + wn * WARP_N + ni * 8 + g;
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float b = wr[e * 4 * S::WP];
                        bhi[ni][e] = ptx::tf32_rna(b);
                        blo[ni][e] = ptx::tf32_rna(b - __uint_as_float(bhi[ni][e]));
                    }
                }
                // the three products as three passes over the warp tile,
                // small terms first: consecutive MMAs update different
                // accumulators, so none waits on the one before
#pragma unroll
                for (int mi = 0; mi < MI; ++mi)
#pragma unroll
                    for (int ni = 0; ni < NI; ++ni)
                        ptx::mma_tf32_1688(part[mi][ni], alo[mi], bhi[ni][0], bhi[ni][1]);
#pragma unroll
                for (int mi = 0; mi < MI; ++mi)
#pragma unroll
                    for (int ni = 0; ni < NI; ++ni)
                        ptx::mma_tf32_1688(part[mi][ni], ahi[mi], blo[ni][0], blo[ni][1]);
#pragma unroll
                for (int mi = 0; mi < MI; ++mi)
#pragma unroll
                    for (int ni = 0; ni < NI; ++ni)
                        ptx::mma_tf32_1688(part[mi][ni], ahi[mi], bhi[ni][0], bhi[ni][1]);
            }
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int ni = 0; ni < NI; ++ni)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    acc[mi][ni][e] += part[mi][ni][e];
                    part[mi][ni][e] = 0.f;
                }
        if (i % n_chunks == n_chunks - 1) {
            const int k = i / n_chunks;
            epilogue(k, smem + S::RING + (k % STAGES) * S::TILE_BYTES);
        }
    }
}

template <int TH, int TW, int CO_T, int WM, int WN, int STAGES, int MINB, bool RAGGED>
int launch_cfg(const void* x, const void* w, const void* scale, const void* bias,
               const void* res, void* out, int B, int H, int W, int C, int Co, int relu,
               cudaStream_t stream) {
    constexpr int smem = Shape<TH, TW, CO_T, STAGES>::SMEM;
    constexpr int threads = WM * WN * 32;
    auto kernel = conv3x3_f32tc_kernel<TH, TW, CO_T, WM, WN, STAGES, MINB, RAGGED>;
    // per device, once: the shared-memory opt-in and how many blocks fit on
    // the card (racing first calls store the same values)
    constexpr int MAX_DEV = 64;
    static int fit[MAX_DEV];  // blocks resident on the whole card; 0 = not set up
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= MAX_DEV) return static_cast<int>(cudaErrorInvalidDevice);
    if (fit[dev] == 0) {
        int sms = 0, per_sm = 0;
        if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        smem)) != cudaSuccess ||
            (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
                cudaSuccess ||
            (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                                 smem)) != cudaSuccess)
            return static_cast<int>(err);
        if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
        fit[dev] = per_sm * sms;
    }
    const int tiles_w = (W + TW - 1) / TW, tiles_hw = (H + TH - 1) / TH * tiles_w;
    const int n_co_tiles = (Co + CO_T - 1) / CO_T;
    const long long n_tiles = (long long)tiles_hw * n_co_tiles * B;
    if (n_tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const int grid = fit[dev] < n_tiles ? fit[dev] : static_cast<int>(n_tiles);
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<const float*>(res), static_cast<float*>(out), H, W, C, Co, tiles_w,
        tiles_hw, n_co_tiles, static_cast<int>(n_tiles), relu);
    return static_cast<int>(cudaGetLastError());
}

// The configuration for Co a multiple of 32, warp-specialised on wgmma.
// Persistent blocks, one an SM, walk 16x16-pixel x N-channel tiles (N = 64
// or 32: the widest that divides Co).
//  * A producer warpgroup keeps a 3-stage ring full, across tile
//    boundaries: per 8-channel chunk the halo and the raw weights by
//    cp.async (zero fill = SAME padding), then, when they have landed, the
//    weights' 3xTF32 split written as K-major core matrices (8 output
//    channels x 4 input channels, 128 bytes), the layout wgmma reads B
//    from; a fence to the async proxy, then the stage's "full" mbarrier.
//  * WGS consumer warpgroups wait on "full", ldmatrix their A fragments
//    from the halo (the tap's shift is the row address), split them in
//    registers and issue per tap and 64-pixel m-tile three wgmma m64nNk8
//    (lo*hi, hi*lo, hi*hi) into a partial sum that the chunk's first
//    product starts from zero; the A registers alternate between two
//    buffers, so a tap's loads and split overlap the previous tap's wgmmas
//    (one group kept in flight); each warp then arrives on the stage's
//    "empty" mbarrier and adds the partial sum into its running sum with
//    round-to-nearest.
//  * setmaxnreg moves registers from the producers to the consumers.
//  * The residual: at 32 channels (near the ridge) the producers stage
//    each tile's into one of two shared buffers with its first chunk, freed
//    by a third mbarrier after the tile's epilogue; at 64 the consumers
//    prefetch its rows into L2 when the tile's last chunk starts. The
//    epilogue then stores from the fragments (f32, 32-byte row segments)
//    while the producers already load the next tile.
namespace ws {

constexpr int TH = 16, TW = 16;
constexpr int WGS = 2, MT = TH * TW / 64 / WGS;  // consumer warpgroups, m-tiles each
constexpr int CONSUMERS = 128 * WGS, PRODUCERS = 128, NT = CONSUMERS + PRODUCERS;
// registers a thread after setmaxnreg: the block is launched with
// 65536 / NT (rounded down to 8); the producers give theirs to the consumers
constexpr int REGS = 65536 / NT / 8 * 8, PROD_REGS = 56;
constexpr int CONS_REGS = (REGS * NT - PROD_REGS * PRODUCERS) / CONSUMERS / 8 * 8;
static_assert(CONS_REGS <= 256, "setmaxnreg's limit");
constexpr int HALO_W = TW + 2, HALO_PX = (TH + 2) * HALO_W;

template <int N>
struct Layout {
    static constexpr int STAGES = 3;
    // N = 32: the residual tile is staged too, in two buffers (tile k % 2)
    static constexpr bool STAGE_RES = N == 32;
    static constexpr int RES_PITCH = pitch_words(N) * 4;  // bytes per pixel
    static constexpr int RES_BYTES = STAGE_RES ? TH * TW * RES_PITCH : 0;
    static constexpr int TAP_B = N * CK * 4;      // one tap's B plane: N/8 x 2 core matrices
    static constexpr int W_HI = 0, W_LO = 9 * TAP_B;  // split weights, K-major
    static constexpr int W_RAW = 2 * 9 * TAP_B;       // raw weights (tap, k, n), n fastest
    static constexpr int HALO = W_RAW + 9 * CK * N * 4;
    static constexpr int STAGE_BYTES = HALO + HALO_PX * CK * 4;
    static constexpr int RES = STAGES * STAGE_BYTES;
    // mbarriers: full[STAGES], empty[STAGES], res_free[2]
    static constexpr int BARS = RES + 2 * RES_BYTES;
    static constexpr int SMEM = BARS + (2 * STAGES + 2) * 8;
    static_assert(STAGE_BYTES % 128 == 0, "core matrices stay 128-byte aligned");
};

template <int N>
__global__ void __launch_bounds__(NT, 1)
conv3x3_f32tc_ws_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ scale, const float* __restrict__ bias,
                        const float* __restrict__ res, float* __restrict__ out, int H, int W,
                        int C, int Co, int tiles_w, int tiles_hw, int n_co_tiles, int n_tiles,
                        int relu) {
    using L = Layout<N>;
    constexpr int STAGES = L::STAGES;
    unsigned char* smem = ptx::dyn_smem();
    const uint32_t sbase = ptx::smem_addr(smem);
    const int tid = threadIdx.x, lane = tid & 31;
    struct Tile {
        int h0, w0, co0, b;
    };
    auto tile_at = [&](int k) {  // this block's k-th tile
        const int t = blockIdx.x + k * gridDim.x;
        const int r = t / n_co_tiles, sp = r % tiles_hw;
        return Tile{(sp / tiles_w) * TH, (sp % tiles_w) * TW, (t % n_co_tiles) * N,
                    r / tiles_hw};
    };
    const int n_chunks = C / CK;
    const int n_items = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x *
                        n_chunks;  // (tile, chunk) pairs of this block
    auto full = [&](int s) { return sbase + L::BARS + s * 8; };
    auto empty = [&](int s) { return sbase + L::BARS + (STAGES + s) * 8; };
    auto res_free = [&](int k) { return sbase + L::BARS + (2 * STAGES + k % 2) * 8; };
    const bool stage_res = L::STAGE_RES && res != nullptr;
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            ptx::mbar_init(full(s), 1);
            ptx::mbar_init(empty(s), CONSUMERS / 32);
        }
        ptx::mbar_init(res_free(0), CONSUMERS / 32);
        ptx::mbar_init(res_free(1), CONSUMERS / 32);
    }
    __syncthreads();

    if (tid >= CONSUMERS) {  // producers
        ptx::setmaxnreg_dec<PROD_REGS>();
        const int p = tid - CONSUMERS;
        for (int i = 0; i <= n_items; ++i) {
            if (i < n_items) {  // stage item i
                const int s = i % STAGES, c0 = (i % n_chunks) * CK;
                const Tile tl = tile_at(i / n_chunks);
                const float* xb = x + (size_t)tl.b * H * W * C;
                if (i >= STAGES) ptx::mbar_wait(empty(s), (i / STAGES - 1) & 1);
                const uint32_t st = sbase + s * L::STAGE_BYTES;
                for (int j = p; j < HALO_PX * 2; j += PRODUCERS) {
                    const int q = j >> 1, u = j & 1;
                    const int gh = tl.h0 - 1 + q / HALO_W, gw = tl.w0 - 1 + q % HALO_W;
                    const bool in = (unsigned)gh < (unsigned)H && (unsigned)gw < (unsigned)W;
                    const float* src = in ? xb + ((size_t)gh * W + gw) * C + c0 + u * 4 : x;
                    ptx::cp_async16(st + L::HALO + x_off(q, u), src, in);
                }
                for (int j = p; j < 9 * CK * N / 4; j += PRODUCERS) {
                    const int row = j / (N / 4), u = j % (N / 4);  // row = tap * CK + k
                    const float* src =
                        w + ((size_t)(row / CK) * C + c0 + row % CK) * Co + tl.co0 + u * 4;
                    ptx::cp_async16(st + L::W_RAW + j * 16, src, true);
                }
                const int k = i / n_chunks;
                if (stage_res && c0 == 0) {  // the tile's residual, once its buffer is free
                    if (k >= 2) ptx::mbar_wait(res_free(k), (k / 2 - 1) & 1);
                    const uint32_t rs = sbase + L::RES + (k % 2) * L::RES_BYTES;
                    for (int j = p; j < TH * TW * N / 4; j += PRODUCERS) {
                        const int m = j / (N / 4), u = j % (N / 4);
                        const int oh = tl.h0 + m / TW, ow = tl.w0 + m % TW;
                        const bool in = oh < H && ow < W;
                        const float* src =
                            in ? res + (((size_t)tl.b * H + oh) * W + ow) * Co + tl.co0 + u * 4
                               : res;
                        ptx::cp_async16(rs + m * L::RES_PITCH + u * 16, src, in);
                    }
                }
                ptx::cp_async_commit();
            }
            if (i >= 1) {  // item i - 1 has landed: split its weights, publish it
                const int s = (i - 1) % STAGES;
                if (i < n_items) ptx::cp_async_wait<1>(); else ptx::cp_async_wait<0>();
                ptx::named_barrier(1, PRODUCERS);
                unsigned char* st = smem + s * L::STAGE_BYTES;
                // unit: (tap, k half, 4 output channels) -> 4 K-major rows
                for (int j = p; j < 9 * 2 * (N / 4); j += PRODUCERS) {
                    const int tap = j / (2 * N / 4), kh = j / (N / 4) % 2, n4 = j % (N / 4);
                    float4 v[4];
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        v[k] = *reinterpret_cast<const float4*>(
                            st + L::W_RAW + ((tap * CK + kh * 4 + k) * N + n4 * 4) * 4);
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const int n = n4 * 4 + c;
                        const int off = tap * L::TAP_B + ((n / 8) * 2 + kh) * 128 + (n % 8) * 16;
                        float hi[4], lo[4];
#pragma unroll
                        for (int k = 0; k < 4; ++k) {
                            const float a = (&v[k].x)[c];
                            hi[k] = __uint_as_float(ptx::tf32_rna(a));
                            lo[k] = __uint_as_float(ptx::tf32_rna(a - hi[k]));
                        }
                        *reinterpret_cast<float4*>(st + L::W_HI + off) =
                            make_float4(hi[0], hi[1], hi[2], hi[3]);
                        *reinterpret_cast<float4*>(st + L::W_LO + off) =
                            make_float4(lo[0], lo[1], lo[2], lo[3]);
                    }
                }
                ptx::fence_proxy_async();
                ptx::named_barrier(1, PRODUCERS);
                if (p == 0) ptx::mbar_arrive(full(s));
            }
        }
        return;
    }

    // consumers: warpgroup wg owns pixels 64 MT wg .. 64 MT (wg + 1) - 1
    ptx::setmaxnreg_inc<CONS_REGS>();
    const int wg = tid / 128, wq = (tid / 32) % 4;
    int a_q[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        const int m = (wg * MT + mt) * 64 + wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        a_q[mt] = (m / TW) * HALO_W + m % TW;
    }
    const int a_u = lane >> 4, g = lane >> 2, t4 = lane & 3;
    // d[4 j + 2 h + e] of m-tile mt is pixel (wg MT + mt) 64 + 16 wq + g + 8 h,
    // channel 8 j + 2 t4 + e
    auto pixel = [&](int mt, int h) { return (wg * MT + mt) * 64 + wq * 16 + g + 8 * h; };
    float acc[MT][N / 2], part[MT][N / 2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < N / 2; ++e) acc[mt][e] = part[mt][e] = 0.f;

    for (int i = 0; i < n_items; ++i) {
        const int s = i % STAGES;
        const bool last = i % n_chunks == n_chunks - 1;
        const Tile tl = tile_at(i / n_chunks);
        ptx::mbar_wait(full(s), (i / STAGES) & 1);
        const uint32_t st = sbase + s * L::STAGE_BYTES;
        if (last && res != nullptr && !L::STAGE_RES && t4 * 32 < N) {
            // the epilogue's residual rows (4 N bytes a pixel) into L2
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int m = pixel(mt, h), oh = tl.h0 + m / TW, ow = tl.w0 + m % TW;
                    if (oh < H && ow < W)
                        ptx::prefetch_l2(res + (((size_t)tl.b * H + oh) * W + ow) * Co +
                                         tl.co0 + t4 * 32);
                }
        }
        uint32_t ahi[2][MT][4], alo[2][MT][4];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
            const int shift = (tap / 3) * HALO_W + tap % 3, buf = tap & 1;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                ptx::ldsm_x4(ahi[buf][mt], st + L::HALO + x_off(a_q[mt] + shift, a_u));
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float a = __uint_as_float(ahi[buf][mt][e]);
                    ahi[buf][mt][e] = ptx::tf32_rna(a);
                    alo[buf][mt][e] = ptx::tf32_rna(a - __uint_as_float(ahi[buf][mt][e]));
                }
            }
            const uint64_t bhi = ptx::smem_desc(st + L::W_HI + tap * L::TAP_B, 128, 256);
            const uint64_t blo = ptx::smem_desc(st + L::W_LO + tap * L::TAP_B, 128, 256);
            ptx::wgmma_fence();
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {  // small terms first
                ptx::wgmma_tf32<N>(part[mt], alo[buf][mt], bhi, tap != 0);
                ptx::wgmma_tf32<N>(part[mt], ahi[buf][mt], blo, 1);
                ptx::wgmma_tf32<N>(part[mt], ahi[buf][mt], bhi, 1);
            }
            ptx::wgmma_commit();
            ptx::wgmma_wait<1>();  // tap t - 1 is done: its A buffer is free
        }
        ptx::wgmma_wait<0>();
        if (lane == 0) ptx::mbar_arrive(empty(s));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < N / 2; ++e) acc[mt][e] += part[mt][e];
        if (!last) continue;

        // epilogue of the tile, straight from the fragments
        const int k = i / n_chunks;
        const unsigned char* rtile = smem + L::RES + (k % 2) * L::RES_BYTES;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
            const int n = tl.co0 + 8 * j + 2 * t4;
            const float2 sc = *reinterpret_cast<const float2*>(scale + n);
            const float2 bi = *reinterpret_cast<const float2*>(bias + n);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int m = pixel(mt, h), oh = tl.h0 + m / TW, ow = tl.w0 + m % TW;
                    float* d = &acc[mt][4 * j + 2 * h];
                    float2 y = make_float2(fmaf(d[0], sc.x, bi.x), fmaf(d[1], sc.y, bi.y));
                    d[0] = d[1] = 0.f;
                    if (oh >= H || ow >= W) continue;
                    const size_t o = (((size_t)tl.b * H + oh) * W + ow) * Co + n;
                    if (res != nullptr) {
                        const float2 rv =
                            stage_res ? *reinterpret_cast<const float2*>(
                                            rtile + m * L::RES_PITCH + (8 * j + 2 * t4) * 4)
                                      : *reinterpret_cast<const float2*>(res + o);
                        y.x += rv.x;
                        y.y += rv.y;
                    }
                    if (relu) {
                        y.x = fmaxf(y.x, 0.f);
                        y.y = fmaxf(y.y, 0.f);
                    }
                    *reinterpret_cast<float2*>(out + o) = y;
                }
        }
        if (stage_res && lane == 0) ptx::mbar_arrive(res_free(k));
    }
}

template <int N>
int launch(const void* x, const void* w, const void* scale, const void* bias, const void* res,
           void* out, int B, int H, int W, int C, int Co, int relu, cudaStream_t stream) {
    constexpr int MAX_DEV = 64;
    static int fit[MAX_DEV];  // blocks resident on the whole card; 0 = not set up
    auto kernel = conv3x3_f32tc_ws_kernel<N>;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= MAX_DEV) return static_cast<int>(cudaErrorInvalidDevice);
    if (fit[dev] == 0) {
        int sms = 0, per_sm = 0;
        if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        Layout<N>::SMEM)) != cudaSuccess ||
            (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
                cudaSuccess ||
            (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                                 Layout<N>::SMEM)) != cudaSuccess)
            return static_cast<int>(err);
        if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
        fit[dev] = per_sm * sms;
    }
    const int tiles_w = (W + TW - 1) / TW, tiles_hw = (H + TH - 1) / TH * tiles_w;
    const int n_co_tiles = Co / N;
    const long long n_tiles = (long long)tiles_hw * n_co_tiles * B;
    if (n_tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const int grid = fit[dev] < n_tiles ? fit[dev] : static_cast<int>(n_tiles);
    kernel<<<grid, NT, Layout<N>::SMEM, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<const float*>(res), static_cast<float*>(out), H, W, C, Co, tiles_w,
        tiles_hw, n_co_tiles, static_cast<int>(n_tiles), relu);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace ws

// The mma.sync configurations (chosen by a sweep on an H100): persistent
// blocks over 8x32-pixel tiles, 2 stages; 16 output channels a block with 4
// warps, two blocks an SM; 8 with 8 warps. Channel tails: RAGGED, 16
// channels a block up to Co = 16, else 48 with 8 warps, one block an SM:
// at Co = 36 one tile, so x is read and each A fragment split once.
int launch_mma_sync(const void* x, const void* w, const void* scale, const void* bias,
                    const void* res, void* out, int B, int H, int W, int C, int Co, int relu,
                    cudaStream_t s) {
    if (C % CK != 0 || Co % 8 != 0) {
        if (Co <= 16)
            return launch_cfg<8, 32, 16, 4, 1, 2, 2, true>(x, w, scale, bias, res, out, B, H, W,
                                                           C, Co, relu, s);
        return launch_cfg<8, 32, 48, 8, 1, 2, 1, true>(x, w, scale, bias, res, out, B, H, W, C,
                                                       Co, relu, s);
    }
    if (Co % 16 == 0)
        return launch_cfg<8, 32, 16, 4, 1, 2, 2, false>(x, w, scale, bias, res, out, B, H, W, C,
                                                        Co, relu, s);
    return launch_cfg<8, 32, 8, 8, 1, 2, 2, false>(x, w, scale, bias, res, out, B, H, W, C, Co,
                                                   relu, s);
}

}  // namespace f32tc
}  // namespace

// Plain C interface for ctypes (ops/cuda/conv2d.py), as conv2d.cu's entries:
// device pointers, `res` may be null, `stream` is a cudaStream_t; returns
// the cudaError_t of the launch (0 = launched). f32 only, any C >= 1 and
// Co >= 1 (wgmma for C % 8 == 0 with Co % 32 == 0, else mma.sync), all
// pointers 16-byte aligned.
extern "C" int uresnet_fused_conv3x3_f32_tc(const void* x, const void* w, const void* scale,
                                            const void* bias, const void* res, void* out,
                                            int B, int H, int W, int C, int Co, int relu,
                                            void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (C < 1 || Co < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (C % f32tc::CK == 0 && Co % 64 == 0)
        return f32tc::ws::launch<64>(x, w, scale, bias, res, out, B, H, W, C, Co, relu, s);
    if (C % f32tc::CK == 0 && Co % 32 == 0)
        return f32tc::ws::launch<32>(x, w, scale, bias, res, out, B, H, W, C, Co, relu, s);
    return f32tc::launch_mma_sync(x, w, scale, bias, res, out, B, H, W, C, Co, relu, s);
}
