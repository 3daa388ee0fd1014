// Fused 3x3 conv + per-channel affine (+ residual) (+ ReLU), NHWC, for Hopper.
//
//   y = relu?( conv3x3_SAME(x, w) * scale + bias [+ residual] )
//
// Replaces the two Pallas kernels of uresnet_tpu/ops/pallas/conv2d.py,
// fused_conv3x3_bn_relu_v2 (:130) and fused_conv3x3_bn_relu (v1, :182),
// which compute this one function (the v1 name is bound to the same entry
// points by ops/cuda/conv2d.py). Contract: x (B,H,W,C) and residual
// (B,H,W,Co) in bf16 or f16, w (3,3,C,Co) in x's dtype, scale/bias (Co,)
// f32, every pointer 16-byte aligned; f32 accumulation, the epilogue in
// f32, one write in x's dtype (f16: round to nearest, beyond 65504 inf).
// f32 operands go to the 3xTF32 kernel of conv2d_f32tc.cu; the wrapper
// (ops/cuda/conv2d.py kernel_for) picks the kernel by dtype alone.
//
// conv3x3_tc_kernel, for any C >= 1 and Co >= 1. An implicit GEMM on the
// tensor cores: M = the TH x TW output pixels of a tile, N = CO_T output
// channels, K = 9*C walked as 16-channel chunks x 9 taps; f32 accumulators
// in registers. bf16 and f16 share mma.sync m16n8k16's fragment layout, so
// one template serves both (Elem<T>: the MMA and the epilogue's
// conversions).
//    What bounds it on an H100 (989 TFLOP/s bf16/f16 dense, 3.35 TB/s): a
//    3x3 conv does 18*C*Co FLOP per pixel and moves 2*(C + Co [+ Co]) bytes.
//    * C, Co <= 32 (the 512^2 and 256^2 levels, ~70-140 FLOP/byte, under
//      the ridge of ~295): memory-bound. One block covers all of Co, so x
//      is read from HBM once; 16x32- or 8x32-pixel tiles keep the halo's
//      re-reads (18*34/512 = 1.2x, 10*34/256 = 1.33x) in L2. The blocks
//      are persistent, as many as fit on the card, and each walks its
//      tiles with one cp.async ring across tile boundaries: the next
//      tile's input and residual load while this tile computes and stores,
//      so HBM never waits for a block to start. Stores are 16 bytes a
//      thread and coalesced.
//    * C >= 64 with Co >= 64 (128^2 and below): compute-bound. 16x16-pixel
//      tiles x 64 or 128 channels, one block per tile; each staged weight
//      chunk feeds 256 pixels and each halo chunk CO_T channels, and a 3-
//      or 4-stage cp.async ring loads the next chunks while chunk k's MMAs
//      run.
//    Operands: the (TH+2) x (TW+2) x 16 input halo is staged in shared
//    memory as loaded, by 16-byte cp.async whose src-size 0 zero-fills
//    outside the image -- that zero fill is the SAME padding, so no padded
//    copy of x is made. A tap's A rows are the halo shifted by (ky, kx):
//    ldmatrix takes one row address per lane, so the shift costs nothing.
//    B is the weights' (3,3,C,Co) layout as it is (K x N, N contiguous),
//    read with ldmatrix.trans. Rows of 32 bytes (a halo pixel's 16
//    channels) or 2*CO_T bytes (a weight row) are XOR-swizzled in 16-byte
//    units so that every 8x8 ldmatrix read is free of bank conflicts.
//    MMA: mma.sync m16n8k16 -> f32, not wgmma. A wgmma version with
//    both operands read from shared memory was built and run on an H100
//    (8-pixel-wide tiles make each tap's shifted halo rows a uniform
//    K-major layout of 8x8 core matrices; the weights staged as N-major
//    core matrices): it agreed with the plain version but, issued by all
//    warps between block-wide barriers, was no faster than this kernel at
//    the 32^2 shapes and slower at the others. Its gain needs the
//    warp-specialised form (a producer warp, mbarriers, consumer
//    warpgroups), which is later work.
//    Epilogue: scale, bias, residual and ReLU in f32 on the accumulator
//    fragments, one rounding to T into a shared output tile (padded rows,
//    no bank conflicts), then 16-byte coalesced stores.
//    Channel tails (RAGGED, a compile-time flag, so the aligned
//    instantiations that serve the model's C and Co multiples of 16 keep
//    their code): ceil(C/16) chunks, the last one's halo channels >= C
//    and weight rows >= C zero-filled in shared memory -- both operands,
//    since a stale value left in a ring slot can be inf or NaN and
//    0 * inf is NaN; ceil(Co/CO_T) channel tiles, weight columns, scale,
//    bias and residual channels >= Co read as zero and stores >= Co masked.
//    Where C (or Co) is a multiple of 8, a pixel's row starts on a 16-byte
//    boundary and each 16-byte unit is whole or wholly past the end: the
//    cp.async above with src-size 0 for the units past it. Otherwise no
//    16-byte copy can read the row: each unit is read element by element
//    through registers, zero past the end, and stored to its swizzled place
//    (and the output stored element by element). Two tile configurations
//    take every tail shape, both persistent over 8x32-pixel tiles: all of
//    Co in one block up to 32 channels, 64-channel tiles above that (at
//    Co = 40 one tile, so x is read once).
//
// The TPU version's pre-padded H copy, H % block_h assert, sequential
// (B, H/block_h) grid and value-level W shifts are TPU artifacts and are
// not carried over.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

namespace tc {

constexpr int CK = 16;  // input channels per pipeline stage: the MMA's K

// 16-byte unit `c` of shared-memory row `row`, XOR-swizzled so that any 8
// consecutive rows read at one unit fall in 8 distinct 16-byte bank groups
// (an 8x8 ldmatrix read is then conflict-free). P = 16-byte units per row.
template <int P>
__device__ __forceinline__ int swz(int row, int c) {
    static_assert(P == 2 || P == 4 || P % 8 == 0, "unsupported row width");
    if constexpr (P >= 8) return c ^ (row & 7);
    else if constexpr (P == 4) return c ^ ((row >> 1) & 3);
    else return c ^ ((row >> 2) & 1);
}

template <int TH, int TW, int CO_T, int STAGES, bool PERSIST>
struct Shape {
    static constexpr int M = TH * TW;                      // pixels per tile
    static constexpr int HALO_W = TW + 2;
    static constexpr int HALO_PX = (TH + 2) * HALO_W;
    static constexpr int HALO_BYTES = HALO_PX * CK * 2;
    static constexpr int W_BYTES = 9 * CK * CO_T * 2;      // 9 taps x CK x CO_T
    static constexpr int STAGE_BYTES = HALO_BYTES + W_BYTES;
    static constexpr int RING = STAGES * STAGE_BYTES;
    // The 16-bit output tile, one pixel's CO_T channels per row; the
    // 16-byte pad puts the 8 rows a fragment store touches in distinct banks.
    static constexpr int TILE_PITCH = CO_T * 2 + 16;
    static constexpr int TILE_BYTES = M * TILE_PITCH;
    // PERSIST: STAGES tiles after the ring, each holding its residual
    // (prefetched) and then its output; else one tile over the spent ring.
    static constexpr int SMEM = PERSIST ? RING + STAGES * TILE_BYTES
                                        : (RING > TILE_BYTES ? RING : TILE_BYTES);
};

// The element type's MMA and the epilogue's conversions of a 32-bit pair
// (channel n in the low half, n + 1 in the high half).
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
    static __device__ __forceinline__ float lo(uint32_t v) { return __uint_as_float(v << 16); }
    static __device__ __forceinline__ float hi(uint32_t v) {
        return __uint_as_float(v & 0xffff0000u);
    }
    static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
        return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
               static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16;
    }
    static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
        ptx::mma_bf16_16816(d, a, b0, b1);
    }
};

template <>
struct Elem<__half> {
    static __device__ __forceinline__ float lo(uint32_t v) {
        return __half2float(__ushort_as_half(static_cast<unsigned short>(v & 0xffffu)));
    }
    static __device__ __forceinline__ float hi(uint32_t v) {
        return __half2float(__ushort_as_half(static_cast<unsigned short>(v >> 16)));
    }
    // round to nearest even; beyond f16's range inf, as Tensor.to(float16)
    static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
        return static_cast<uint32_t>(__half_as_ushort(__float2half_rn(lo))) |
               static_cast<uint32_t>(__half_as_ushort(__float2half_rn(hi))) << 16;
    }
    static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
        ptx::mma_f16_16816(d, a, b0, b1);
    }
};

// Elements [0, n) of the 8 16-bit values at `src`, read one by one, zero
// from n on (n <= 0: all zero, nothing read): a 16-byte unit of a row that
// does not start on a 16-byte boundary.
__device__ __forceinline__ uint4 load_unit(const void* src, int n) {
    const unsigned short* s = static_cast<const unsigned short*>(src);
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
        v[e] = (2 * e < n ? static_cast<uint32_t>(s[2 * e]) : 0u) |
               (2 * e + 1 < n ? static_cast<uint32_t>(s[2 * e + 1]) << 16 : 0u);
    return make_uint4(v[0], v[1], v[2], v[3]);
}

// One 16-byte unit of a row, elements [0, n) from `src`, zero from n on,
// into shared memory at `dst` (`dst_ptr` its generic address). `vec`: the
// row starts on a 16-byte boundary, so the unit is whole (n >= 8) or past
// the end (n <= 0): one cp.async, zero-filled past the end (`any`, a valid
// address, is read then: src-size 0 reads nothing). Else element by
// element through registers.
__device__ __forceinline__ void stage_unit(uint32_t dst, unsigned char* dst_ptr, const void* src,
                                           const void* any, int n, bool vec) {
    if (vec)
        ptx::cp_async16(dst, n > 0 ? src : any, n > 0);
    else
        *reinterpret_cast<uint4*>(dst_ptr) = load_unit(src, n);
}

// One tile = TH x TW output pixels x CO_T channels of one image. With
// PERSIST a block walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... and
// its cp.async ring runs across tile boundaries, so the next tile's input
// and residual load while this tile computes and stores (the memory-bound
// configurations); without it the grid has one block per tile. RAGGED:
// any C and Co (the channel tails of the header comment); without it C
// and Co are multiples of 16 and of CO_T.
template <typename T, int TH, int TW, int CO_T, int WM, int WN, int STAGES, int MINB,
          bool PERSIST, bool RAGGED>
__global__ void __launch_bounds__(WM * WN * 32, MINB)
conv3x3_tc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  const T* __restrict__ res, T* __restrict__ out,
                  int H, int W, int C, int Co, int tiles_w, int tiles_hw, int n_co_tiles,
                  int n_tiles, int relu) {
    using S = Shape<TH, TW, CO_T, STAGES, PERSIST>;
    using E = Elem<T>;
    static_assert(sizeof(T) == 2, "a 16-bit element type");
    constexpr int NT = WM * WN * 32;
    constexpr int WARP_M = S::M / WM, WARP_N = CO_T / WN;
    constexpr int MI = WARP_M / 16, NI = WARP_N / 8;
    constexpr int PA = CK / 8;    // 16-byte units per halo pixel
    constexpr int PB = CO_T / 8;  // 16-byte units per weight row (and per output pixel)
    static_assert(WARP_M % 16 == 0 && WARP_N % 16 == 0, "warp tile");
    static_assert(TW % 8 == 0, "an 8-row ldmatrix group stays in one tile row");
    static_assert(PERSIST || !RAGGED, "channel tails prefetch the residual");
    // Byte offsets in a ring slot of 16-byte unit u (8 channels) of halo
    // pixel q and of weight row r = tap * CK + k.
    auto x_off = [](int q, int u) { return (q * PA + swz<PA>(q, u)) * 16; };
    auto w_off = [](int r, int u) { return (r * PB + swz<PB>(r, u)) * 16; };

    unsigned char* smem = ptx::dyn_smem();
    const uint32_t sbase = ptx::smem_addr(smem);

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int wm = warp % WM, wn = warp / WM;
    // RAGGED: whether x's and the Co-wide rows (w, residual, out) start on
    // 16-byte boundaries
    const bool x_vec = C % 8 == 0, o_vec = Co % 8 == 0;

    // this block's k-th tile: (first row, first column, first channel,
    // image); neighbouring tile indices share a halo
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
    // weights; with PERSIST, a tile's first item also brings its residual.
    auto load_item = [&](int i, int slot) {
        const int k = i / n_chunks, c0 = (i % n_chunks) * CK;
        const Tile tl = tile_at(k);
        const T* xb = x + (size_t)tl.b * H * W * C;
        const uint32_t hs = sbase + slot * S::STAGE_BYTES;
        unsigned char* hp = smem + slot * S::STAGE_BYTES;
        for (int j = tid; j < S::HALO_PX * PA; j += NT) {
            const int q = j / PA, u = j % PA;
            const int gh = tl.h0 - 1 + q / S::HALO_W, gw = tl.w0 - 1 + q % S::HALO_W;
            const bool in = (unsigned)gh < (unsigned)H && (unsigned)gw < (unsigned)W;
            if constexpr (RAGGED) {
                const int c = c0 + u * 8;
                stage_unit(hs + x_off(q, u), hp + x_off(q, u),
                           in ? xb + ((size_t)gh * W + gw) * C + c : x, x, in ? C - c : 0,
                           x_vec);
            } else {
                const T* src = in ? xb + ((size_t)gh * W + gw) * C + c0 + u * 8 : x;
                ptx::cp_async16(hs + x_off(q, u), src, in);
            }
        }
        const uint32_t ws = hs + S::HALO_BYTES;
        for (int j = tid; j < 9 * CK * PB; j += NT) {
            const int r = j / PB, u = j % PB;  // r = tap * CK + k
            const T* src = w + ((size_t)(r / CK) * C + c0 + r % CK) * Co + tl.co0 + u * 8;
            if constexpr (RAGGED) {
                const int co = tl.co0 + u * 8;
                stage_unit(ws + w_off(r, u), hp + S::HALO_BYTES + w_off(r, u), src, w,
                           c0 + r % CK < C ? Co - co : 0, o_vec);
            } else {
                ptx::cp_async16(ws + w_off(r, u), src, true);
            }
        }
        if (PERSIST && c0 == 0 && res != nullptr) {
            const int ts = S::RING + (k % STAGES) * S::TILE_BYTES;
            for (int j = tid; j < S::M * PB; j += NT) {
                const int m = j / PB, u = j % PB;
                const int oh = tl.h0 + m / TW, ow = tl.w0 + m % TW;
                const bool in = oh < H && ow < W;
                const T* src =
                    in ? res + (((size_t)tl.b * H + oh) * W + ow) * Co + tl.co0 + u * 8 : res;
                const int off = ts + m * S::TILE_PITCH + u * 16;
                if constexpr (RAGGED)
                    stage_unit(sbase + off, smem + off, src, res, in ? Co - (tl.co0 + u * 8) : 0,
                               o_vec);
                else
                    ptx::cp_async16(sbase + off, src, in);
            }
        }
    };

    // This lane's ldmatrix rows. A: pixel m of m16 tile mi, 16-byte unit
    // a_u (channels 0-7 or 8-15); B: weight row k of a tap, unit b_u + 2j.
    int a_q[MI];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
        const int m = wm * WARP_M + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        a_q[mi] = (m / TW) * S::HALO_W + m % TW;
    }
    const int a_u = lane >> 4;
    const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int b_u = wn * WARP_N / 8 + (lane >> 4);
    const int g = lane >> 2, t4 = lane & 3;  // accumulator fragment: row g, columns 2*t4

    float acc[MI][NI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    // Tile k is summed. The epilogue in f32 on the fragments: scale, bias,
    // residual, ReLU; one rounding to T into the shared output tile; then
    // 16-byte coalesced stores of the tile's pixels inside the image (and
    // its channels below Co).
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
                    float lo = fmaf(acc[mi][ni][2 * h], sc.x, bi.x);
                    float hi = fmaf(acc[mi][ni][2 * h + 1], sc.y, bi.y);
                    uint32_t* cell = reinterpret_cast<uint32_t*>(tile + m * S::TILE_PITCH + n * 2);
                    if (res != nullptr) {
                        uint32_t rv = 0;
                        if (PERSIST) {  // prefetched into the tile
                            rv = *cell;
                        } else {
                            const int oh = tl.h0 + m / TW, ow = tl.w0 + m % TW;
                            if (oh < H && ow < W)
                                rv = *reinterpret_cast<const uint32_t*>(
                                    res + (((size_t)tl.b * H + oh) * W + ow) * Co + tl.co0 + n);
                        }
                        lo += E::lo(rv);
                        hi += E::hi(rv);
                    }
                    if (relu) {
                        lo = fmaxf(lo, 0.f);
                        hi = fmaxf(hi, 0.f);
                    }
                    *cell = E::pack(lo, hi);
                    acc[mi][ni][2 * h] = acc[mi][ni][2 * h + 1] = 0.f;
                }
        }
        __syncthreads();
        for (int j = tid; j < S::M * PB; j += NT) {
            const int m = j / PB, u = j % PB;
            const int oh = tl.h0 + m / TW, ow = tl.w0 + m % TW;
            if (oh >= H || ow >= W) continue;
            T* dst = out + (((size_t)tl.b * H + oh) * W + ow) * Co + tl.co0 + u * 8;
            const unsigned char* cell = tile + m * S::TILE_PITCH + u * 16;
            const int n = Co - (tl.co0 + u * 8);  // channels of this unit below Co
            if (!RAGGED || (o_vec && n > 0)) {
                *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(cell);
            } else if (!o_vec) {  // a row that is not 16-byte aligned: element by element
                for (int e = 0; e < 8 && e < n; ++e)
                    reinterpret_cast<unsigned short*>(dst)[e] =
                        reinterpret_cast<const unsigned short*>(cell)[e];
            }
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
        const uint32_t ws = hs + S::HALO_BYTES;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
            const int shift = (tap / 3) * S::HALO_W + tap % 3;
            uint32_t af[MI][4], bfr[NI / 2][4];
#pragma unroll
            for (int mi = 0; mi < MI; ++mi)
                ptx::ldsm_x4(af[mi], hs + x_off(a_q[mi] + shift, a_u));
#pragma unroll
            for (int j = 0; j < NI / 2; ++j)
                ptx::ldsm_x4_trans(bfr[j], ws + w_off(tap * CK + b_k, b_u + 2 * j));
#pragma unroll
            for (int mi = 0; mi < MI; ++mi)
#pragma unroll
                for (int ni = 0; ni < NI; ++ni)
                    E::mma(acc[mi][ni], af[mi], bfr[ni / 2][(ni & 1) * 2],
                           bfr[ni / 2][(ni & 1) * 2 + 1]);
        }
        if (PERSIST && i % n_chunks == n_chunks - 1) {
            const int k = i / n_chunks;
            epilogue(k, smem + S::RING + (k % STAGES) * S::TILE_BYTES);
        }
    }
    if (!PERSIST) {  // one tile per block: its output tile reuses the spent ring
        ptx::cp_async_wait<0>();
        __syncthreads();
        epilogue(0, smem);
    }
}

template <typename T, int TH, int TW, int CO_T, int WM, int WN, int STAGES, int MINB,
          bool PERSIST, bool RAGGED>
int launch_tc(const void* x, const void* w, const void* scale, const void* bias,
              const void* res, void* out, int B, int H, int W, int C, int Co, int relu,
              cudaStream_t stream) {
    constexpr int smem = Shape<TH, TW, CO_T, STAGES, PERSIST>::SMEM;
    constexpr int threads = WM * WN * 32;
    auto kernel = conv3x3_tc_kernel<T, TH, TW, CO_T, WM, WN, STAGES, MINB, PERSIST, RAGGED>;
    // per device, once: the shared-memory opt-in and, for the persistent
    // grid, how many blocks fit on the card (racing first calls store the
    // same values)
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
    // persistent: as many blocks as fit on the card at once
    const int grid = PERSIST && fit[dev] < n_tiles ? fit[dev] : static_cast<int>(n_tiles);
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<const T*>(res), static_cast<T*>(out), H, W,
        C, Co, tiles_w, tiles_hw, n_co_tiles, static_cast<int>(n_tiles), relu);
    return static_cast<int>(cudaGetLastError());
}

// Tile configuration by shape (chosen by a sweep on an H100): C and Co
// multiples of 16 take the widest channel tile that divides Co. 16 or 32
// channels: the memory-bound regime, persistent blocks, all of Co in one
// block when Co <= 32; 16x32-pixel tiles at 16 channels, 8x32 at 32. 64 or
// 128 channels: the compute-bound regime, one block per 16x16-pixel tile,
// warp tiles of 64 x 64 (4 warps at 64 channels, 8 at 128), a 3- or
// 4-stage ring. Other C or Co: RAGGED, persistent 8x32-pixel tiles, all
// of Co in one block up to 64 channels (32- or 64-channel tiles; 64 at
// 8 warps takes 132 KB of shared memory, one block an SM).
template <typename T>
int launch(const void* x, const void* w, const void* scale, const void* bias, const void* res,
           void* out, int B, int H, int W, int C, int Co, int relu, cudaStream_t s) {
    if (C < 1 || Co < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (C % CK == 0 && Co % 16 == 0) {
        if (Co % 128 == 0)
            return launch_tc<T, 16, 16, 128, 4, 2, 4, 1, false, false>(x, w, scale, bias, res,
                                                                       out, B, H, W, C, Co,
                                                                       relu, s);
        if (Co % 64 == 0)
            return launch_tc<T, 16, 16, 64, 4, 1, 3, 2, false, false>(x, w, scale, bias, res,
                                                                      out, B, H, W, C, Co, relu,
                                                                      s);
        if (Co % 32 == 0)
            return launch_tc<T, 8, 32, 32, 8, 1, 2, 2, true, false>(x, w, scale, bias, res, out,
                                                                    B, H, W, C, Co, relu, s);
        return launch_tc<T, 16, 32, 16, 8, 1, 2, 2, true, false>(x, w, scale, bias, res, out, B,
                                                                 H, W, C, Co, relu, s);
    }
    if (Co > 32)
        return launch_tc<T, 8, 32, 64, 8, 1, 2, 1, true, true>(x, w, scale, bias, res, out, B,
                                                               H, W, C, Co, relu, s);
    return launch_tc<T, 8, 32, 32, 8, 1, 2, 2, true, true>(x, w, scale, bias, res, out, B, H, W,
                                                           C, Co, relu, s);
}

}  // namespace tc
}  // namespace

// Plain C interface for ctypes (ops/cuda/conv2d.py). Pointers are device
// pointers, all 16-byte aligned; `res` may be null; `stream` is a
// cudaStream_t. Any C >= 1 and Co >= 1. Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int uresnet_fused_conv3x3_bf16_tc(const void* x, const void* w, const void* scale,
                                             const void* bias, const void* res, void* out,
                                             int B, int H, int W, int C, int Co, int relu,
                                             void* stream) {
    return tc::launch<__nv_bfloat16>(x, w, scale, bias, res, out, B, H, W, C, Co, relu,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" int uresnet_fused_conv3x3_f16_tc(const void* x, const void* w, const void* scale,
                                            const void* bias, const void* res, void* out,
                                            int B, int H, int W, int C, int Co, int relu,
                                            void* stream) {
    return tc::launch<__half>(x, w, scale, bias, res, out, B, H, W, C, Co, relu,
                              static_cast<cudaStream_t>(stream));
}

extern "C" const char* uresnet_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
