// Fused 3x3 conv + per-channel affine (+ residual) (+ ReLU), NHWC, for Hopper.
//
//   y = relu?( conv3x3_SAME(x, w) * scale + bias [+ residual] )
//
// Replaces the two Pallas kernels of uresnet_tpu/ops/pallas/conv2d.py,
// fused_conv3x3_bn_relu_v2 (:130) and fused_conv3x3_bn_relu (v1, :182),
// which compute this one function (the v1 name is bound to the same entry
// points by ops/cuda/conv2d.py). Contract: x (B,H,W,C) and residual
// (B,H,W,Co) in bf16 or f32, w (3,3,C,Co) in x's dtype, scale/bias (Co,)
// f32; f32 accumulation, the epilogue in f32, one write in x's dtype.
//
// Two kernels, chosen by the wrapper by dtype and shape:
//
// 1. conv3x3_tc_kernel, bf16 with C and Co multiples of 16 -- every conv of
//    the serving forward. An implicit GEMM on the tensor cores: M = the
//    TH x TW output pixels of a tile, N = CO_T output channels, K = 9*C
//    walked as 16-channel chunks x 9 taps; f32 accumulators in registers.
//    What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): a 3x3
//    conv does 18*C*Co FLOP per pixel and moves 2*(C + Co [+ Co]) bytes.
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
//    memory as loaded, bf16, by 16-byte cp.async whose src-size 0 zero-fills
//    outside the image -- that zero fill is the SAME padding, so no padded
//    copy of x is made. A tap's A rows are the halo shifted by (ky, kx):
//    ldmatrix takes one row address per lane, so the shift costs nothing.
//    B is the weights' (3,3,C,Co) layout as it is (K x N, N contiguous),
//    read with ldmatrix.trans. Rows of 32 bytes (a halo pixel's 16
//    channels) or 2*CO_T bytes (a weight row) are XOR-swizzled in 16-byte
//    units so that every 8x8 ldmatrix read is free of bank conflicts.
//    MMA: mma.sync m16n8k16 bf16 -> f32, not wgmma. A wgmma version with
//    both operands read from shared memory was built and run on an H100
//    (8-pixel-wide tiles make each tap's shifted halo rows a uniform
//    K-major layout of 8x8 core matrices; the weights staged as N-major
//    core matrices): it agreed with the plain version but, issued by all
//    warps between block-wide barriers, was no faster than this kernel at
//    the 32^2 shapes and slower at the others. Its gain needs the
//    warp-specialised form (a producer warp, mbarriers, consumer
//    warpgroups), which is later work.
//    Epilogue: scale, bias, residual and ReLU in f32 on the accumulator
//    fragments, one bf16 rounding into a shared output tile (padded rows,
//    no bank conflicts), then 16-byte coalesced stores.
//
// 2. fused_conv3x3_kernel, the CUDA-core kernel: f32 (tensor cores would
//    mean TF32, and f32 compute stays true f32) and bf16 whose C or Co is
//    not a multiple of 16. A block owns a TILE_H x TILE_W patch and CO_TILE
//    output channels, stages the halo and the weights per 16-channel chunk
//    in shared memory converted to f32, and runs f32 FMAs; ragged edges and
//    channel tails are masked, so any H, W, C, Co are taken.
//
// The TPU version's pre-padded H copy, H % block_h assert, sequential
// (B, H/block_h) grid and value-level W shifts are TPU artifacts and are
// not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// Inline-PTX wrappers for the tensor-core kernel: cp.async with zero fill,
// ldmatrix, and the bf16 mma.sync (sm_80 and later).

namespace ptx {

// The block's dynamic shared memory.
__device__ __forceinline__ unsigned char* dyn_smem() {
    extern __shared__ __align__(128) unsigned char smem_buf[];
    return smem_buf;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy, bypassing L1. With valid == false nothing
// is read (src-size 0) and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives, in r[i], row l / 4, columns 2(l % 4) and 2(l % 4) + 1
// of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// The same, transposed: r[i] holds rows 2(l % 4) and 2(l % 4) + 1 of
// column l / 4 of matrix i.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// d += a (16x16, row-major fragments) * b (16x8, column-major), bf16 in,
// f32 accumulate.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace ptx

namespace {

constexpr int TILE_H = 8;
constexpr int TILE_W = 16;
constexpr int ROWS = 4;          // output rows per thread (2 row groups x 16 columns = 1 warp)
constexpr int CK = 16;           // input channels per shared-memory chunk
constexpr int HALO_H = TILE_H + 2;
constexpr int HALO_W = TILE_W + 2;
constexpr int HALO_STRIDE = 20;  // >= HALO_W; lanes 16-31 read 4 rows (80 words) down: 16 banks over

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

template <typename T, int CO_TILE>
__global__ void __launch_bounds__(CO_TILE / 4 * 32)
fused_conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     const T* __restrict__ res, T* __restrict__ out,
                     int H, int W, int C, int Co, int tiles_w, int relu) {
    constexpr int NTHREADS = CO_TILE / 4 * 32;
    __shared__ float s_in[CK][HALO_H][HALO_STRIDE];
    __shared__ __align__(16) float s_w[9][CK][CO_TILE];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int cog = tid >> 5;          // this warp's 4 output channels: cog*4 .. cog*4+3
    const int col = lane & 15;         // output column within the tile
    const int r0 = (lane >> 4) * ROWS; // first of this thread's output rows

    const int h0 = (blockIdx.x / tiles_w) * TILE_H;
    const int w0 = (blockIdx.x % tiles_w) * TILE_W;
    const int co0 = blockIdx.y * CO_TILE;
    const int b = blockIdx.z;
    const T* xb = x + (size_t)b * H * W * C;

    float acc[ROWS][4];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < C; c0 += CK) {
        __syncthreads();  // the previous chunk is fully consumed
        // input halo, channel fastest: a warp reads contiguous channels of a pixel
        for (int i = tid; i < HALO_H * HALO_W * CK; i += NTHREADS) {
            const int c = i % CK;
            const int p = i / CK;
            const int hy = p / HALO_W, hx = p % HALO_W;
            const int gh = h0 - 1 + hy, gw = w0 - 1 + hx, gc = c0 + c;
            float v = 0.f;
            if (gh >= 0 && gh < H && gw >= 0 && gw < W && gc < C)
                v = to_f32(xb[((size_t)gh * W + gw) * C + gc]);
            s_in[c][hy][hx] = v;
        }
        // weights (3,3,C,Co): output channel fastest, contiguous in memory
        for (int i = tid; i < 9 * CK * CO_TILE; i += NTHREADS) {
            const int co = i % CO_TILE;
            const int c = (i / CO_TILE) % CK;
            const int k = i / (CO_TILE * CK);
            const int gc = c0 + c, gco = co0 + co;
            float v = 0.f;
            if (gc < C && gco < Co)
                v = to_f32(w[((size_t)k * C + gc) * Co + gco]);
            s_w[k][c][co] = v;
        }
        __syncthreads();

#pragma unroll 2
        for (int c = 0; c < CK; ++c) {
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) {
                float v[ROWS + 2];
#pragma unroll
                for (int i = 0; i < ROWS + 2; ++i) v[i] = s_in[c][r0 + i][col + kx];
#pragma unroll
                for (int ky = 0; ky < 3; ++ky) {
                    const float4 wv =
                        *reinterpret_cast<const float4*>(&s_w[ky * 3 + kx][c][cog * 4]);
#pragma unroll
                    for (int i = 0; i < ROWS; ++i) {
                        const float a = v[i + ky];
                        acc[i][0] = fmaf(a, wv.x, acc[i][0]);
                        acc[i][1] = fmaf(a, wv.y, acc[i][1]);
                        acc[i][2] = fmaf(a, wv.z, acc[i][2]);
                        acc[i][3] = fmaf(a, wv.w, acc[i][3]);
                    }
                }
            }
        }
    }

    // epilogue: affine, residual, ReLU in f32; one store in T
    const int ow = w0 + col;
    if (ow >= W) return;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
        const int oh = h0 + r0 + i;
        if (oh >= H) break;
        const size_t base = (((size_t)b * H + oh) * W + ow) * Co;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int co = co0 + cog * 4 + j;
            if (co >= Co) break;
            float y = acc[i][j] * scale[co] + bias[co];
            if (res != nullptr) y += to_f32(res[base + co]);
            if (relu) y = fmaxf(y, 0.f);
            out[base + co] = from_f32<T>(y);
        }
    }
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           const void* res, void* out, int B, int H, int W, int C, int Co,
           int relu, void* stream) {
    const int tiles_w = (W + TILE_W - 1) / TILE_W;
    const int tiles_h = (H + TILE_H - 1) / TILE_H;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const T* xp = static_cast<const T*>(x);
    const T* wp = static_cast<const T*>(w);
    const float* sp = static_cast<const float*>(scale);
    const float* bp = static_cast<const float*>(bias);
    const T* rp = static_cast<const T*>(res);
    T* op = static_cast<T*>(out);
    if (Co % 32 == 0) {
        dim3 grid(tiles_h * tiles_w, Co / 32, B);
        fused_conv3x3_kernel<T, 32><<<grid, 256, 0, s>>>(xp, wp, sp, bp, rp, op, H, W, C,
                                                          Co, tiles_w, relu);
    } else {
        dim3 grid(tiles_h * tiles_w, (Co + 15) / 16, B);
        fused_conv3x3_kernel<T, 16><<<grid, 128, 0, s>>>(xp, wp, sp, bp, rp, op, H, W, C,
                                                          Co, tiles_w, relu);
    }
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16, C % 16 == 0, Co % 16 == 0).

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
    // The bf16 output tile, one pixel's CO_T channels per row; the 16-byte
    // pad puts the 8 rows a fragment store touches in distinct banks.
    static constexpr int TILE_PITCH = CO_T * 2 + 16;
    static constexpr int TILE_BYTES = M * TILE_PITCH;
    // PERSIST: STAGES tiles after the ring, each holding its residual
    // (prefetched) and then its output; else one tile over the spent ring.
    static constexpr int SMEM = PERSIST ? RING + STAGES * TILE_BYTES
                                        : (RING > TILE_BYTES ? RING : TILE_BYTES);
};

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
           static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16;
}

// One tile = TH x TW output pixels x CO_T channels of one image. With
// PERSIST a block walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... and
// its cp.async ring runs across tile boundaries, so the next tile's input
// and residual load while this tile computes and stores (the memory-bound
// configurations); without it the grid has one block per tile.
template <int TH, int TW, int CO_T, int WM, int WN, int STAGES, int MINB, bool PERSIST>
__global__ void __launch_bounds__(WM * WN * 32, MINB)
conv3x3_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
                  int H, int W, int C, int Co, int tiles_w, int tiles_hw, int n_co_tiles,
                  int n_tiles, int relu) {
    using S = Shape<TH, TW, CO_T, STAGES, PERSIST>;
    constexpr int NT = WM * WN * 32;
    constexpr int WARP_M = S::M / WM, WARP_N = CO_T / WN;
    constexpr int MI = WARP_M / 16, NI = WARP_N / 8;
    constexpr int PA = CK / 8;    // 16-byte units per halo pixel
    constexpr int PB = CO_T / 8;  // 16-byte units per weight row (and per output pixel)
    static_assert(WARP_M % 16 == 0 && WARP_N % 16 == 0, "warp tile");
    static_assert(TW % 8 == 0, "an 8-row ldmatrix group stays in one tile row");
    // Byte offsets in a ring slot of 16-byte unit u (8 channels) of halo
    // pixel q and of weight row r = tap * CK + k.
    auto x_off = [](int q, int u) { return (q * PA + swz<PA>(q, u)) * 16; };
    auto w_off = [](int r, int u) { return (r * PB + swz<PB>(r, u)) * 16; };

    unsigned char* smem = ptx::dyn_smem();
    const uint32_t sbase = ptx::smem_addr(smem);

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int wm = warp % WM, wn = warp / WM;

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
    const int n_chunks = C / CK;
    const int n_items = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x *
                        n_chunks;  // (tile, chunk) pairs of this block

    // Stage item i (chunk i % n_chunks of tile i / n_chunks) into ring slot
    // `slot`: the halo, zero outside the image, then the 9 taps' CK x CO_T
    // weights; with PERSIST, a tile's first item also brings its residual.
    auto load_item = [&](int i, int slot) {
        const int k = i / n_chunks, c0 = (i % n_chunks) * CK;
        const Tile tl = tile_at(k);
        const __nv_bfloat16* xb = x + (size_t)tl.b * H * W * C;
        const uint32_t hs = sbase + slot * S::STAGE_BYTES;
        for (int j = tid; j < S::HALO_PX * PA; j += NT) {
            const int q = j / PA, u = j % PA;
            const int gh = tl.h0 - 1 + q / S::HALO_W, gw = tl.w0 - 1 + q % S::HALO_W;
            const bool in = (unsigned)gh < (unsigned)H && (unsigned)gw < (unsigned)W;
            const __nv_bfloat16* src = in ? xb + ((size_t)gh * W + gw) * C + c0 + u * 8 : x;
            ptx::cp_async16(hs + x_off(q, u), src, in);
        }
        const uint32_t ws = hs + S::HALO_BYTES;
        for (int j = tid; j < 9 * CK * PB; j += NT) {
            const int r = j / PB, u = j % PB;  // r = tap * CK + k
            const __nv_bfloat16* src =
                w + ((size_t)(r / CK) * C + c0 + r % CK) * Co + tl.co0 + u * 8;
            ptx::cp_async16(ws + w_off(r, u), src, true);
        }
        if (PERSIST && c0 == 0 && res != nullptr) {
            const uint32_t ts = sbase + S::RING + (k % STAGES) * S::TILE_BYTES;
            for (int j = tid; j < S::M * PB; j += NT) {
                const int m = j / PB, u = j % PB;
                const int oh = tl.h0 + m / TW, ow = tl.w0 + m % TW;
                const bool in = oh < H && ow < W;
                const __nv_bfloat16* src =
                    in ? res + (((size_t)tl.b * H + oh) * W + ow) * Co + tl.co0 + u * 8 : res;
                ptx::cp_async16(ts + m * S::TILE_PITCH + u * 16, src, in);
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
    // residual, ReLU; one bf16 rounding into the shared output tile; then
    // 16-byte coalesced stores of the tile's pixels inside the image.
    auto epilogue = [&](int k, unsigned char* tile) {
        const Tile tl = tile_at(k);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
            const int n = wn * WARP_N + ni * 8 + 2 * t4;
            const float2 sc = *reinterpret_cast<const float2*>(scale + tl.co0 + n);
            const float2 bi = *reinterpret_cast<const float2*>(bias + tl.co0 + n);
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
                        lo += bf16_lo(rv);
                        hi += bf16_hi(rv);
                    }
                    if (relu) {
                        lo = fmaxf(lo, 0.f);
                        hi = fmaxf(hi, 0.f);
                    }
                    *cell = pack_bf16(lo, hi);
                    acc[mi][ni][2 * h] = acc[mi][ni][2 * h + 1] = 0.f;
                }
        }
        __syncthreads();
        for (int j = tid; j < S::M * PB; j += NT) {
            const int m = j / PB, u = j % PB;
            const int oh = tl.h0 + m / TW, ow = tl.w0 + m % TW;
            if (oh < H && ow < W)
                *reinterpret_cast<uint4*>(out + (((size_t)tl.b * H + oh) * W + ow) * Co +
                                          tl.co0 + u * 8) =
                    *reinterpret_cast<const uint4*>(tile + m * S::TILE_PITCH + u * 16);
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
                    ptx::mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni / 2][(ni & 1) * 2],
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

template <int TH, int TW, int CO_T, int WM, int WN, int STAGES, int MINB, bool PERSIST>
int launch_tc(const void* x, const void* w, const void* scale, const void* bias,
              const void* res, void* out, int B, int H, int W, int C, int Co, int relu,
              cudaStream_t stream) {
    constexpr int smem = Shape<TH, TW, CO_T, STAGES, PERSIST>::SMEM;
    constexpr int threads = WM * WN * 32;
    auto kernel = conv3x3_tc_kernel<TH, TW, CO_T, WM, WN, STAGES, MINB, PERSIST>;
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
    const int n_co_tiles = Co / CO_T;
    const long long n_tiles = (long long)tiles_hw * n_co_tiles * B;
    if (n_tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    // persistent: as many blocks as fit on the card at once
    const int grid = PERSIST && fit[dev] < n_tiles ? fit[dev] : static_cast<int>(n_tiles);
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(out), H, W, C, Co,
        tiles_w, tiles_hw, n_co_tiles, static_cast<int>(n_tiles), relu);
    return static_cast<int>(cudaGetLastError());
}

// Tile configuration by shape (chosen by a sweep on an H100): the widest
// channel tile that divides Co. 16 or 32 channels: the memory-bound regime,
// persistent blocks, all of Co in one block when Co <= 32; 16x32-pixel
// tiles at 16 channels, 8x32 at 32. 64 or 128 channels: the compute-bound
// regime, one block per 16x16-pixel tile, warp tiles of 64 x 64 (4 warps
// at 64 channels, 8 at 128), a 3- or 4-stage ring.
int launch(const void* x, const void* w, const void* scale, const void* bias, const void* res,
           void* out, int B, int H, int W, int C, int Co, int relu, cudaStream_t s) {
    if (C % CK != 0 || Co % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (Co % 128 == 0)
        return launch_tc<16, 16, 128, 4, 2, 4, 1, false>(x, w, scale, bias, res, out, B, H, W,
                                                         C, Co, relu, s);
    if (Co % 64 == 0)
        return launch_tc<16, 16, 64, 4, 1, 3, 2, false>(x, w, scale, bias, res, out, B, H, W, C,
                                                        Co, relu, s);
    if (Co % 32 == 0)
        return launch_tc<8, 32, 32, 8, 1, 2, 2, true>(x, w, scale, bias, res, out, B, H, W, C,
                                                      Co, relu, s);
    return launch_tc<16, 32, 16, 8, 1, 2, 2, true>(x, w, scale, bias, res, out, B, H, W, C, Co,
                                                   relu, s);
}

}  // namespace tc
}  // namespace

// Plain C interface for ctypes (ops/cuda/conv2d.py). Pointers are device
// pointers; `res` may be null; `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int uresnet_fused_conv3x3_f32(const void* x, const void* w, const void* scale,
                                         const void* bias, const void* res, void* out,
                                         int B, int H, int W, int C, int Co, int relu,
                                         void* stream) {
    return launch<float>(x, w, scale, bias, res, out, B, H, W, C, Co, relu, stream);
}

extern "C" int uresnet_fused_conv3x3_bf16(const void* x, const void* w, const void* scale,
                                          const void* bias, const void* res, void* out,
                                          int B, int H, int W, int C, int Co, int relu,
                                          void* stream) {
    return launch<__nv_bfloat16>(x, w, scale, bias, res, out, B, H, W, C, Co, relu, stream);
}

// The tensor-core kernel: bf16 only, C and Co multiples of 16; all
// pointers 16-byte aligned.
extern "C" int uresnet_fused_conv3x3_bf16_tc(const void* x, const void* w, const void* scale,
                                             const void* bias, const void* res, void* out,
                                             int B, int H, int W, int C, int Co, int relu,
                                             void* stream) {
    return tc::launch(x, w, scale, bias, res, out, B, H, W, C, Co, relu,
                      static_cast<cudaStream_t>(stream));
}

extern "C" const char* uresnet_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
