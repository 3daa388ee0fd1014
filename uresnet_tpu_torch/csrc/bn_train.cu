// Train-mode BatchNorm with the residual add and the ReLU that follow it:
// two kernels forward (statistics, affine) and two backward (gradient sums,
// input gradient). Bound to PyTorch by ops/cuda/bn_train.py.
//
// It replaces no Pallas kernel: in the JAX package XLA generates train BN
// (uresnet_tpu/ops/norm.py) and fuses it with its neighbours; in the port
// the same function ran as a chain of torch elementwise and reduce passes
// under autograd, which read and wrote each activation many times over, in
// f32. These kernels do that function in the fewest passes.
//
// What bounds them on the card: bytes. Each does a few flops an element
// against 2-10 bytes, far below the ~295 flops a byte where the H100's
// arithmetic would be the limit, so the design keeps to one read of each
// operand and one write of each output per kernel:
//   stats        reads x     -> sum x, sum x^2, mean, var, rstd, running stats (f32)
//   apply        reads x (+ residual), writes out
//   grad_reduce  reads dout, x (+ out for the mask)   -> sum dy', sum dy'*xhat
//   grad_input   reads dout, x (+ out), writes dx (+ dy' for the residual)
// where dy' = dout * [out > 0] under the ReLU (the mask recomputed from x
// when no residual was added, so `out` is read only where it has to be).
// The per-channel constants (scale*rstd, bias - mean*scale*rstd, the
// gradient sums over N) sit in registers; every thread owns a fixed
// 16-byte column slice of the (rows, phases*C) activation, so its channels
// never change along the rows it walks, and a warp's loads are whole
// 16-byte vectors of neighbouring addresses.
//
// The two reductions need no atomics on their sums: each block writes its
// per-column partial sums to scratch, and the last block to finish (an
// integer ticket) sums them over blocks and phases in a fixed order, so a
// run reproduces bit for bit. That block also sets the ticket back to 0
// for the next reduction on its stream, so no memset runs between them,
// and in the statistics kernel it finishes mean, var, rstd and the new
// running stats, so the forward needs no pass over the per-channel
// vectors between or after its two kernels. Arithmetic is f32 throughout (f64 for a float64 activation),
// with one rounding to the activation dtype.
//
// Layout: every tensor is contiguous, viewed as (rows, W), W = phases * C;
// column j is channel j % C. The launch geometry (vector width, threads
// per row, blocks) comes from ops/cuda/bn_train.py `geometry`.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // threads of a block (tx * ty <= kThreads)
// Each kernel loads U rows of its operands before it uses any: 4 in the
// forward kernels, 2 in the gradient kernels, whose operands and per-lane
// constants would otherwise spill past the registers that their launch
// bounds leave (4 blocks an SM for stats, 2 for the others).

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

template <typename T> __device__ __forceinline__ float to_acc(T v);
template <> __device__ __forceinline__ float to_acc(float v) { return v; }
template <> __device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_acc(__half v) { return __half2float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }

template <typename T, typename A> __device__ __forceinline__ T from_acc(A v);
template <> __device__ __forceinline__ float from_acc<float, float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16, float>(float v) {
    return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_acc<__half, float>(float v) {
    return __float2half(v);
}
template <> __device__ __forceinline__ double from_acc<double, double>(double v) { return v; }

// V elements of T, loaded and stored as one access (16 bytes when V is
// 16 / sizeof(T)).
template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T v[V]; };

// Which column slice a thread owns, and where in a block's pass of
// rows_per_pass rows its row lies.
struct Tile {
    int tx, ty, rows_per_pass;
    int64_t row0;  // the thread's first row; then every gridDim.x * rows_per_pass
    int64_t col;   // first column of the thread's slice; -1: idle thread
};

template <int V> __device__ __forceinline__ Tile tile(int W, int TX) {
    Tile t;
    t.tx = threadIdx.x % TX;
    t.ty = threadIdx.x / TX;
    t.rows_per_pass = blockDim.x / TX;
    t.row0 = (int64_t)blockIdx.x * t.rows_per_pass + t.ty;
    const int v = blockIdx.y * TX + t.tx;
    t.col = (int64_t)v * V < W ? (int64_t)v * V : -1;
    return t;
}

// g = scale * rstd, b = bias - mean * g for the V channels of a slice.
template <typename A, int V>
__device__ __forceinline__ void affine(const A* mean, const A* rstd, const A* scale,
                                       const A* bias, int64_t col, int C, A* g, A* b) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
        const int c = (int)((col + k) % C);
        g[k] = scale[c] * rstd[c];
        b[k] = bias[c] - mean[c] * g[k];
    }
}

__device__ __forceinline__ float fma_acc(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_acc(double a, double b, double c) { return fma(a, b, c); }

// The ReLU mask of an element: from the forward's output where it was
// read, else recomputed from x as the forward computed it.
template <typename A>
__device__ __forceinline__ bool kept(bool relu, bool from_out, A out_v, A x_v, A g, A b) {
    if (!relu) return true;
    return from_out ? out_v > A(0) : fma_acc(x_v, g, b) > A(0);
}

// Block and grid reduction of the per-thread sums s1, s2 of a V-column
// slice. A block's partials go to part[blockIdx.x][2][width]: per channel
// (its phases summed) when the block covers whole rows (gridDim.y == 1,
// width C), else per column of its tile (width W). The last block to
// finish sums them over blocks (and phases) into sums[0:C] and
// sums[C:2C], in a fixed order, and sets the ticket back to 0. Returns
// true in that block, whose threads then see every sum.
template <typename A, int V>
__device__ bool reduce_to_sums(const A (&s1)[V], const A (&s2)[V], const Tile& t, A* part,
                               unsigned* ticket, A* sums, int W, int C, int TX) {
    constexpr int kMaxV = 8;  // the widest V: 16 bytes of a 2-byte type
    __shared__ A sh[2 * kThreads * kMaxV];
    __shared__ bool last;
    const int span = TX * V;  // columns of the block's tile
    const int ny = t.rows_per_pass;
    const bool whole = gridDim.y == 1;
    const int width = whole ? C : W;
#pragma unroll
    for (int k = 0; k < V; ++k) {
        sh[t.ty * span + t.tx * V + k] = s1[k];
        sh[(ny + t.ty) * span + t.tx * V + k] = s2[k];
    }
    __syncthreads();
    // over the block's rows: column j's sums into sh[j], sh[ny * span + j]
    const int64_t col0 = (int64_t)blockIdx.y * span;
    for (int j = threadIdx.x; j < span; j += blockDim.x) {
        A a = 0, q = 0;
        for (int y = 0; y < ny; ++y) {
            a += sh[y * span + j];
            q += sh[(ny + y) * span + j];
        }
        sh[j] = a;
        sh[ny * span + j] = q;
        if (!whole && col0 + j < W) {
            part[(int64_t)blockIdx.x * 2 * W + col0 + j] = a;
            part[((int64_t)blockIdx.x * 2 + 1) * W + col0 + j] = q;
        }
    }
    if (whole) {  // over the phases
        __syncthreads();
        for (int j = threadIdx.x; j < 2 * C; j += blockDim.x) {
            const int s = j / C, c = j % C;
            A a = 0;
            for (int p = c; p < W; p += C) a += sh[s * ny * span + p];
            part[((int64_t)blockIdx.x * 2 + s) * C + c] = a;
        }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
        last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
    __syncthreads();
    if (!last) return false;
    __threadfence();
    if (threadIdx.x == 0) *ticket = 0u;  // every block has counted
    // the last block: sums[s*C + c] = sum over blocks bx (and phases p) of
    // part[bx][s][p*C + c]. The blocks split over G groups of threads; a
    // thread loads 8 of its blocks' partials at once into 4 accumulators;
    // then the accumulators and the groups are summed in order.
    const int P = width / C;
    const int64_t nb = gridDim.x, bstride = 2 * (int64_t)width;
    const int pairs = 2 * C;
    const int G = pairs < (int)blockDim.x ? (int)blockDim.x / pairs : 1;
    for (int i = threadIdx.x; i < pairs * G; i += blockDim.x) {
        const int j = i % pairs, g = i / pairs, s = j / C, c = j % C;
        A acc[4] = {0, 0, 0, 0};
        for (int p = 0; p < P; ++p) {  // P = 1 where blocks covered whole rows
            const A* q = part + (int64_t)s * width + p * C + c;
            int64_t bx = g;
            for (; bx + 7 * G < nb; bx += 8 * G) {
                A v[8];
#pragma unroll
                for (int u = 0; u < 8; ++u) v[u] = __ldcg(q + (bx + u * G) * bstride);
#pragma unroll
                for (int u = 0; u < 8; ++u) acc[u & 3] += v[u];
            }
            for (; bx < nb; bx += G) acc[0] += __ldcg(q + bx * bstride);
        }
        const A total = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        if (G == 1)
            sums[j] = total;
        else
            sh[g * pairs + j] = total;
    }
    if (G > 1) {
        __syncthreads();
        for (int j = threadIdx.x; j < pairs; j += blockDim.x) {
            A acc = 0;
            for (int g = 0; g < G; ++g) acc += sh[g * pairs + j];
            sums[j] = acc;
        }
    }
    __syncthreads();
    return true;
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// mean, biased var = E[x^2] - mean^2 and rstd = 1 / sqrt(var + eps) of a
// channel from its sums over n elements, rounded as ops/cuda/bn_train.py
// `moments` rounds them in torch (no contraction into fma).
__device__ __forceinline__ void moments(float s1, float s2, float n, float eps, float* mean,
                                        float* var, float* rstd) {
    const float m = __fdiv_rn(s1, n);
    const float v = __fsub_rn(__fdiv_rn(s2, n), __fmul_rn(m, m));
    *mean = m;
    *var = v;
    *rstd = rsqrtf(__fadd_rn(v, eps));
}
__device__ __forceinline__ void moments(double s1, double s2, double n, double eps, double* mean,
                                        double* var, double* rstd) {
    const double m = __ddiv_rn(s1, n);
    const double v = __dsub_rn(__ddiv_rn(s2, n), __dmul_rn(m, m));
    *mean = m;
    *var = v;
    *rstd = 1.0 / sqrt(__dadd_rn(v, eps));
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 4)
    bn_train_stats_kernel(const T* __restrict__ x, typename Acc<T>::type* part, unsigned* ticket,
                          typename Acc<T>::type* sums, const typename Acc<T>::type* run_mean,
                          const typename Acc<T>::type* run_var, int64_t rows, int W, int C,
                          int TX, double count, double eps, double momentum) {
    using A = typename Acc<T>::type;
    using P = Pack<T, V>;
    constexpr int U = 4;
    const Tile t = tile<V>(W, TX);
    A s1[V], s2[V];
#pragma unroll
    for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0;
    if (t.col >= 0) {
        const int64_t step = (int64_t)gridDim.x * t.rows_per_pass, stride = step * W;
        int64_t off = t.row0 * W + t.col;
        for (int64_t r0 = t.row0; r0 < rows; r0 += step * U, off += stride * U) {
            bool ok[U];
#pragma unroll
            for (int u = 0; u < U; ++u) ok[u] = r0 + u * step < rows;
            P xs[U];
#pragma unroll
            for (int u = 0; u < U; ++u)
                if (ok[u]) xs[u] = *reinterpret_cast<const P*>(x + off + u * stride);
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (!ok[u]) continue;
#pragma unroll
                for (int k = 0; k < V; ++k) {
                    const A v = to_acc(xs[u].v[k]);
                    s1[k] += v;
                    s2[k] = fma_acc(v, v, s2[k]);
                }
            }
        }
    }
    if (!reduce_to_sums<A, V>(s1, s2, t, part, ticket, sums, W, C, TX)) return;
    // the last block: [sum x | sum x^2 | count | mean | var | rstd | the
    // running mean and var moved by momentum], rounded as torch rounds
    // state * momentum + stat * (1 - momentum)
    const A n = (A)count, m = (A)momentum, m1 = (A)(1.0 - momentum);
    if (threadIdx.x == 0) sums[2 * C] = n;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        A mean, var;
        moments(sums[c], sums[C + c], n, (A)eps, &mean, &var, sums + 4 * C + 1 + c);
        sums[2 * C + 1 + c] = mean;
        sums[3 * C + 1 + c] = var;
        sums[5 * C + 1 + c] = add_rn(mul_rn(run_mean[c], m), mul_rn(mean, m1));
        sums[6 * C + 1 + c] = add_rn(mul_rn(run_var[c], m), mul_rn(var, m1));
    }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
    bn_train_apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                          const typename Acc<T>::type* mean, const typename Acc<T>::type* rstd,
                          const typename Acc<T>::type* scale, const typename Acc<T>::type* bias,
                          T* __restrict__ out, int64_t rows, int W, int C, int TX, int relu) {
    using A = typename Acc<T>::type;
    using P = Pack<T, V>;
    constexpr int U = 4;
    const Tile t = tile<V>(W, TX);
    if (t.col < 0) return;
    A g[V], b[V];
    affine<A, V>(mean, rstd, scale, bias, t.col, C, g, b);
    const int64_t step = (int64_t)gridDim.x * t.rows_per_pass, stride = step * W;
    int64_t off = t.row0 * W + t.col;
    for (int64_t r0 = t.row0; r0 < rows; r0 += step * U, off += stride * U) {
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) ok[u] = r0 + u * step < rows;
        P xs[U], rs[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (!ok[u]) continue;
            xs[u] = *reinterpret_cast<const P*>(x + off + u * stride);
            if (res) rs[u] = *reinterpret_cast<const P*>(res + off + u * stride);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (!ok[u]) continue;
            P o;
#pragma unroll
            for (int k = 0; k < V; ++k) {
                A z = fma_acc(to_acc(xs[u].v[k]), g[k], b[k]);
                if (res) z += to_acc(rs[u].v[k]);
                if (relu && z < A(0)) z = A(0);
                o.v[k] = from_acc<T, A>(z);
            }
            *reinterpret_cast<P*>(out + off + u * stride) = o;
        }
    }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
    bn_train_grad_reduce_kernel(const T* __restrict__ dout, const T* __restrict__ x,
                                const T* __restrict__ out, const typename Acc<T>::type* mean,
                                const typename Acc<T>::type* rstd,
                                const typename Acc<T>::type* scale,
                                const typename Acc<T>::type* bias, typename Acc<T>::type* part,
                                unsigned* ticket, typename Acc<T>::type* sums, int64_t rows,
                                int W, int C, int TX, int relu) {
    using A = typename Acc<T>::type;
    using P = Pack<T, V>;
    constexpr int U = 2;
    const Tile t = tile<V>(W, TX);
    A s1[V], s2[V];
#pragma unroll
    for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0;
    if (t.col >= 0) {
        A g[V], b[V], mu[V], rs[V];
        affine<A, V>(mean, rstd, scale, bias, t.col, C, g, b);
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const int c = (int)((t.col + k) % C);
            mu[k] = mean[c];
            rs[k] = rstd[c];
        }
        const bool from_out = out != nullptr;
        const int64_t step = (int64_t)gridDim.x * t.rows_per_pass, stride = step * W;
        int64_t off = t.row0 * W + t.col;
        for (int64_t r0 = t.row0; r0 < rows; r0 += step * U, off += stride * U) {
            bool ok[U];
#pragma unroll
            for (int u = 0; u < U; ++u) ok[u] = r0 + u * step < rows;
            P ds[U], xs[U], os[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (!ok[u]) continue;
                ds[u] = *reinterpret_cast<const P*>(dout + off + u * stride);
                xs[u] = *reinterpret_cast<const P*>(x + off + u * stride);
                if (from_out) os[u] = *reinterpret_cast<const P*>(out + off + u * stride);
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (!ok[u]) continue;
#pragma unroll
                for (int k = 0; k < V; ++k) {
                    const A xv = to_acc(xs[u].v[k]);
                    const A ov = from_out ? to_acc(os[u].v[k]) : A(0);
                    const A dy = kept(relu, from_out, ov, xv, g[k], b[k])
                                     ? to_acc(ds[u].v[k]) : A(0);
                    s1[k] += dy;
                    s2[k] = fma_acc(dy, (xv - mu[k]) * rs[k], s2[k]);
                }
            }
        }
    }
    reduce_to_sums<A, V>(s1, s2, t, part, ticket, sums, W, C, TX);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
    bn_train_grad_input_kernel(const T* __restrict__ dout, const T* __restrict__ x,
                               const T* __restrict__ out, const typename Acc<T>::type* mean,
                               const typename Acc<T>::type* rstd,
                               const typename Acc<T>::type* scale,
                               const typename Acc<T>::type* bias,
                               const typename Acc<T>::type* gsums,
                               const typename Acc<T>::type* count, T* __restrict__ dx,
                               T* __restrict__ dres, int64_t rows, int W, int C, int TX,
                               int relu) {
    using A = typename Acc<T>::type;
    using P = Pack<T, V>;
    constexpr int U = 2;
    const Tile t = tile<V>(W, TX);
    if (t.col < 0) return;
    A g[V], b[V], mu[V], rs[V], k1[V], k2[V];
    affine<A, V>(mean, rstd, scale, bias, t.col, C, g, b);
    const A inv_n = A(1) / count[0];
#pragma unroll
    for (int k = 0; k < V; ++k) {
        const int c = (int)((t.col + k) % C);
        mu[k] = mean[c];
        rs[k] = rstd[c];
        k1[k] = gsums[c] * inv_n;
        k2[k] = gsums[C + c] * inv_n;
    }
    const bool from_out = out != nullptr;
    const int64_t step = (int64_t)gridDim.x * t.rows_per_pass, stride = step * W;
    int64_t off = t.row0 * W + t.col;
    for (int64_t r0 = t.row0; r0 < rows; r0 += step * U, off += stride * U) {
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) ok[u] = r0 + u * step < rows;
        P ds[U], xs[U], os[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (!ok[u]) continue;
            ds[u] = *reinterpret_cast<const P*>(dout + off + u * stride);
            xs[u] = *reinterpret_cast<const P*>(x + off + u * stride);
            if (from_out) os[u] = *reinterpret_cast<const P*>(out + off + u * stride);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (!ok[u]) continue;
            P dxo, dro;
#pragma unroll
            for (int k = 0; k < V; ++k) {
                const A xv = to_acc(xs[u].v[k]);
                const A ov = from_out ? to_acc(os[u].v[k]) : A(0);
                const bool on = kept(relu, from_out, ov, xv, g[k], b[k]);
                const A dy = on ? to_acc(ds[u].v[k]) : A(0);
                const A xh = (xv - mu[k]) * rs[k];
                dxo.v[k] = from_acc<T, A>(g[k] * (dy - k1[k] - xh * k2[k]));
                dro.v[k] = on ? ds[u].v[k] : from_acc<T, A>(A(0));
            }
            *reinterpret_cast<P*>(dx + off + u * stride) = dxo;
            if (dres) *reinterpret_cast<P*>(dres + off + u * stride) = dro;
        }
    }
}

// Launch geometry from ops/cuda/bn_train.py: grid (gx, gy), blocks of
// tx * (kThreads / tx) threads, vector width `vec` (16 / sizeof(T) or 1).
struct Geom {
    int vec, tx, gx, gy;
    dim3 grid() const { return dim3(gx, gy); }
    dim3 block() const { return dim3(tx * (kThreads / tx)); }
};

// f(std::integral_constant<int, V>) for the geometry's vector width.
template <typename T, typename F> int by_vec(int vec, F&& f) {
    constexpr int kVec = 16 / sizeof(T);
    if (vec == kVec) return f(std::integral_constant<int, kVec>());
    if (vec == 1) return f(std::integral_constant<int, 1>());
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_stats(const Geom& gm, const void* x, void* part, void* ticket, void* sums,
                 const void* run_mean, const void* run_var, int64_t rows, int W, int C,
                 double count, double eps, double momentum, cudaStream_t s) {
    using A = typename Acc<T>::type;
    return by_vec<T>(gm.vec, [&](auto v) {
        bn_train_stats_kernel<T, decltype(v)::value><<<gm.grid(), gm.block(), 0, s>>>(
            static_cast<const T*>(x), static_cast<A*>(part), static_cast<unsigned*>(ticket),
            static_cast<A*>(sums), static_cast<const A*>(run_mean),
            static_cast<const A*>(run_var), rows, W, C, gm.tx, count, eps, momentum);
        return static_cast<int>(cudaGetLastError());
    });
}

template <typename T>
int launch_apply(const Geom& gm, const void* x, const void* res, const void* mean,
                 const void* rstd, const void* scale, const void* bias, void* out,
                 int64_t rows, int W, int C, int relu, cudaStream_t s) {
    using A = typename Acc<T>::type;
    return by_vec<T>(gm.vec, [&](auto v) {
        bn_train_apply_kernel<T, decltype(v)::value><<<gm.grid(), gm.block(), 0, s>>>(
            static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const A*>(mean),
            static_cast<const A*>(rstd), static_cast<const A*>(scale),
            static_cast<const A*>(bias), static_cast<T*>(out), rows, W, C, gm.tx, relu);
        return static_cast<int>(cudaGetLastError());
    });
}

template <typename T>
int launch_grad_reduce(const Geom& gm, const void* dout, const void* x, const void* out,
                       const void* mean, const void* rstd, const void* scale, const void* bias,
                       void* part, void* ticket, void* sums, int64_t rows, int W, int C,
                       int relu, cudaStream_t s) {
    using A = typename Acc<T>::type;
    return by_vec<T>(gm.vec, [&](auto v) {
        bn_train_grad_reduce_kernel<T, decltype(v)::value><<<gm.grid(), gm.block(), 0, s>>>(
            static_cast<const T*>(dout), static_cast<const T*>(x), static_cast<const T*>(out),
            static_cast<const A*>(mean), static_cast<const A*>(rstd),
            static_cast<const A*>(scale), static_cast<const A*>(bias), static_cast<A*>(part),
            static_cast<unsigned*>(ticket), static_cast<A*>(sums), rows, W, C, gm.tx, relu);
        return static_cast<int>(cudaGetLastError());
    });
}

template <typename T>
int launch_grad_input(const Geom& gm, const void* dout, const void* x, const void* out,
                      const void* mean, const void* rstd, const void* scale, const void* bias,
                      const void* gsums, const void* count, void* dx, void* dres, int64_t rows,
                      int W, int C, int relu, cudaStream_t s) {
    using A = typename Acc<T>::type;
    return by_vec<T>(gm.vec, [&](auto v) {
        bn_train_grad_input_kernel<T, decltype(v)::value><<<gm.grid(), gm.block(), 0, s>>>(
            static_cast<const T*>(dout), static_cast<const T*>(x), static_cast<const T*>(out),
            static_cast<const A*>(mean), static_cast<const A*>(rstd),
            static_cast<const A*>(scale), static_cast<const A*>(bias),
            static_cast<const A*>(gsums), static_cast<const A*>(count), static_cast<T*>(dx),
            static_cast<T*>(dres), rows, W, C, gm.tx, relu);
        return static_cast<int>(cudaGetLastError());
    });
}

// dtype codes of the C interface
enum { kF32 = 0, kBF16 = 1, kF16 = 2, kF64 = 3 };

#define BN_BY_DTYPE(DT, FN, ...)                                        \
    switch (DT) {                                                       \
        case kF32: return FN<float>(__VA_ARGS__);                       \
        case kBF16: return FN<__nv_bfloat16>(__VA_ARGS__);              \
        case kF16: return FN<__half>(__VA_ARGS__);                      \
        case kF64: return FN<double>(__VA_ARGS__);                      \
        default: return static_cast<int>(cudaErrorInvalidValue);       \
    }

}  // namespace

// Plain C interface for ctypes (ops/cuda/bn_train.py). `dtype`: 0 f32,
// 1 bf16, 2 f16, 3 f64 (the activations'; the per-channel vectors and sums
// are f32, f64 for f64). Activations are contiguous (rows, W); with vec > 1
// every activation pointer is 16-byte aligned and W a multiple of vec.
// `part` holds gx * 2 * W sums and `ticket` one unsigned, 0 before the
// launch and 0 again after it (a workspace that the reductions of one
// stream share). The statistics' `sums` holds 7C + 1 values: sum x, sum
// x^2, count, mean, var, rstd, and the running mean and var (`run_mean`,
// `run_var`, C each) moved by `momentum`.
// `res`, `out` (the mask's source; null: recompute it from x) and `dres`
// may be null. `stream` is a cudaStream_t. Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int uresnet_bn_train_stats(int dtype, int vec, int tx, int gx, int gy, const void* x,
                                      void* part, void* ticket, void* sums, const void* run_mean,
                                      const void* run_var, int64_t rows, int W, int C,
                                      double count, double eps, double momentum, void* stream) {
    const Geom gm{vec, tx, gx, gy};
    BN_BY_DTYPE(dtype, launch_stats, gm, x, part, ticket, sums, run_mean, run_var, rows, W, C,
                count, eps, momentum, static_cast<cudaStream_t>(stream));
}

extern "C" int uresnet_bn_train_apply(int dtype, int vec, int tx, int gx, int gy, const void* x,
                                      const void* res, const void* mean, const void* rstd,
                                      const void* scale, const void* bias, void* out,
                                      int64_t rows, int W, int C, int relu, void* stream) {
    const Geom gm{vec, tx, gx, gy};
    BN_BY_DTYPE(dtype, launch_apply, gm, x, res, mean, rstd, scale, bias, out, rows, W, C, relu,
                static_cast<cudaStream_t>(stream));
}

extern "C" int uresnet_bn_train_grad_reduce(int dtype, int vec, int tx, int gx, int gy,
                                            const void* dout, const void* x, const void* out,
                                            const void* mean, const void* rstd,
                                            const void* scale, const void* bias, void* part,
                                            void* ticket, void* sums, int64_t rows, int W,
                                            int C, int relu, void* stream) {
    const Geom gm{vec, tx, gx, gy};
    BN_BY_DTYPE(dtype, launch_grad_reduce, gm, dout, x, out, mean, rstd, scale, bias, part, ticket,
                sums, rows, W, C, relu, static_cast<cudaStream_t>(stream));
}

extern "C" int uresnet_bn_train_grad_input(int dtype, int vec, int tx, int gx, int gy,
                                           const void* dout, const void* x, const void* out,
                                           const void* mean, const void* rstd,
                                           const void* scale, const void* bias,
                                           const void* gsums, const void* count, void* dx,
                                           void* dres, int64_t rows, int W, int C, int relu,
                                           void* stream) {
    const Geom gm{vec, tx, gx, gy};
    BN_BY_DTYPE(dtype, launch_grad_input, gm, dout, x, out, mean, rstd, scale, bias, gsums, count,
                dx, dres, rows, W, C, relu, static_cast<cudaStream_t>(stream));
}
