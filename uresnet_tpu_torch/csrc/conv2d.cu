// Fused 3x3 conv + per-channel affine (+ residual) (+ ReLU), NHWC, for Hopper.
//
//   y = relu?( conv3x3_SAME(x, w) * scale + bias [+ residual] )
//
// Replaces uresnet_tpu/ops/pallas/conv2d.py::fused_conv3x3_bn_relu_v2, the
// TPU kernel of the BN-folded serving forward (models/fold.py). Same
// contract: x (B,H,W,C) and residual (B,H,W,Co) in bf16 or f32, w (3,3,C,Co)
// in x's dtype, scale/bias (Co,) f32; f32 accumulation, the epilogue in f32
// registers, one write-back in x's dtype.
//
// What bounds it on an H100: a 3x3 conv does 2*9*C*Co FLOP per pixel and
// moves 2*(C+Co) bytes (bf16). At C = Co = 16 (the 512^2 level) that is
// ~72 FLOP/byte, under the card's bf16 ridge (~295), so memory-bound; at
// 512 channels it is ~2300 FLOP/byte, compute-bound. Fusing the epilogue
// saves one full read and write of the activation per conv against a conv
// followed by a separate bias/residual/ReLU pass.
//
// Design (first version: simple and right; tensor cores, TMA and
// pipelining are later work):
//   * a block owns a TILE_H x TILE_W patch of one image and CO_TILE output
//     channels; grid = (spatial tiles, Co tiles, batch), all independent;
//   * per chunk of CK input channels it stages the (TILE_H+2) x (TILE_W+2)
//     input halo in shared memory, zero-filled outside the image — that
//     zero fill IS the SAME padding, so no padded copy of x is made — and
//     the matching 3x3 x CK x CO_TILE weights, both converted to f32;
//   * one warp per 4 output channels; a lane owns one column and 4 rows, so
//     16 f32 accumulators, and each input value read from shared memory
//     feeds 12 FMAs (3 kernel rows x 4 channels) with the weights broadcast
//     as float4 across the warp;
//   * ragged bottom/right edges and C, Co tails are masked, so any H, W, C,
//     Co are taken.
// The TPU version's pre-padded H copy, H % block_h assert, sequential
// (B, H/block_h) grid and value-level W shifts are TPU artifacts and are
// not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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

extern "C" const char* uresnet_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
