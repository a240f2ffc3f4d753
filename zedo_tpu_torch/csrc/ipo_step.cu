// Kernel #4: one IPO Adam step (zedo_tpu_torch/zeroshot/ipo.py `_ipo_body`)
// for every row in one launch.
//
// It replaces no TPU kernel: the JAX package runs IPO through XLA
// (zedo_tpu/zeroshot/ipo.py, no `pl.pallas_call`). On the card the step was
// an autograd forward and backward plus a per-leaf Adam update, about 200
// small kernels a step replayed from one CUDA graph, far above what the step
// moves. Each row's trajectory is independent: the loss is a sum of
// per-group means, so a row's gradient is its own residual signs times the
// constant 1 / (rows in its group x keys x 2). A step reads the row's packed
// constants (5 a key, then T and K: 5 * keys + 12 floats) and reads and
// writes its learned leaves and their Adam moments: ~46 floats a row at 3
// keys and the z axis, ~103 at 12 keys and xyz. That bounds it at ~2.4 us
// at 44,300 x 3 and ~1.2 us at 10,000 x 12 on an H100 (3.35 TB/s); the
// constants stay in L2 from step to step.
//
// Design: four threads a row (kLanes), keys j, j + 4, ... on lane j % 4, so
// that 10,000 rows of 12 keys fill the card as 44,300 rows of 3 do; the
// row's partial sums meet by two xor shuffles, ((l0 + l1) + (l2 + l3)), on
// every lane, and each lane takes the Adam step of its own leaf (lane 0 w and
// the scale, lanes 1-3 the axes x, y, z), its moments read with the row's
// values at the start. Constants are laid out [5 * keys +
// 12, rows] so that neighbouring rows read neighbouring words. Every
// product and sum is an explicitly rounded intrinsic (no contraction into
// FMA), in the order of the plain version (ops/kernels/ipo_kernel.py
// `ipo_step_reference`), so the two agree bit for bit on the same inputs; the
// row's L1 sum is written per row and reduced after the scan, so nothing is
// summed by atomics. The gradient follows autograd's rules: abs backward is
// sign (0 at 0); clamp backward passes where min <= s <= max.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;
constexpr int kRowsPerBlock = 32;
constexpr int kThreads = kLanes * kRowsPerBlock;

// A learned leaf's values and Adam moments, [rows] each; all null where the
// axis is not learned.
struct Leaf {
  float* p;
  float* m;
  float* v;
};

struct StepArgs {
  const float* consts;  // [5 * keys + 12, rows]: per key px py pz tu tv, then T (3), K (9)
  int rows, keys;
  Leaf w, x, y, z, s;
  const float* corrections;  // [iterations, 2]: reciprocals of Adam's bias corrections
  const int64_t* counter;    // [1]: the step, the row of `corrections`
  float* row_loss;           // [rows]: the row's L1 sum at the step's entry parameters
  float weight, lr, lo, hi, b1, one_minus_b1, b2, one_minus_b2, eps;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float dot(float a0, float a1, float a2, float b0, float b1, float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

// ((l0 + l1) + (l2 + l3)) of the row's four lanes, on every lane
__device__ __forceinline__ float lane_sum(float a) {
  a = add(a, __shfl_xor_sync(0xffffffffu, a, 1));
  return add(a, __shfl_xor_sync(0xffffffffu, a, 2));
}

__device__ __forceinline__ float l1_sign(float r, float weight) {
  return r > 0.f ? weight : (r < 0.f ? -weight : 0.f);
}

// optax's Adam on one leaf of row r from its value and moments (m0, v0)
__device__ __forceinline__ void adam(const Leaf& leaf, int r, float value, float m0, float v0,
                                     float g, float c1, float c2, const StepArgs& a) {
  const float m = add(mul(m0, a.b1), mul(g, a.one_minus_b1));
  const float v = add(mul(v0, a.b2), mul(mul(g, g), a.one_minus_b2));
  const float upd = __fdiv_rn(mul(m, c1), add(__fsqrt_rn(mul(v, c2)), a.eps));
  leaf.m[r] = m;
  leaf.v[r] = v;
  leaf.p[r] = sub(value, mul(upd, a.lr));
}

__global__ void __launch_bounds__(kThreads) ipo_step(const StepArgs a) {
  const int lane = threadIdx.x % kLanes;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes;
  // rows past the end compute on the last row, for the shuffles, and write nothing
  const int r = row < a.rows ? row : a.rows - 1;
  const size_t n = a.rows;
  const float* c = a.consts + r;

  const float w = a.w.p[r];
  const float vx = a.x.p ? a.x.p[r] : 0.f;
  const float vy = a.y.p ? a.y.p[r] : 0.f;
  const float vz = a.z.p ? a.z.p[r] : 0.f;
  const float s = a.s.p[r];
  // the leaf this lane steps (lane 0: w, and the scale; lanes 1-3: x, y, z),
  // its moments and the step's corrections, read before they are needed
  const Leaf own = lane == 0 ? a.w : (lane == 1 ? a.x : (lane == 2 ? a.y : a.z));
  const float own_m = own.p ? own.m[r] : 0.f, own_v = own.p ? own.v[r] : 0.f;
  const float s_m = lane == 0 ? a.s.m[r] : 0.f, s_v = lane == 0 ? a.s.v[r] : 0.f;
  const int64_t step = *a.counter;
  const float c1 = a.corrections[2 * step], c2 = a.corrections[2 * step + 1];
  const float norm = add(add(add(mul(w, w), mul(vx, vx)), mul(vy, vy)), mul(vz, vz));
  const float rn = __frcp_rn(norm);
  const float f = mul(rn, 2.f);
  const float sc = fminf(fmaxf(s, a.lo), a.hi);
  const size_t base = (size_t)5 * a.keys;
  const float t0 = c[base * n], t1 = c[(base + 1) * n], t2 = c[(base + 2) * n];
  const float tx = mul(t0, sc), ty = mul(t1, sc), tz = mul(t2, sc);
  float k[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) k[i] = c[(base + 3 + i) * n];

  float sg0 = 0.f, sg1 = 0.f, sg2 = 0.f, gr = 0.f, gc1 = 0.f, gv0 = 0.f, gv1 = 0.f, gv2 = 0.f;
  float loss = 0.f;
  for (int j = lane; j < a.keys; j += kLanes) {
    const float* cj = c + (size_t)5 * j * n;
    const float p0 = cj[0], p1 = cj[n], p2 = cj[2 * n], tu = cj[3 * n], tv = cj[4 * n];
    // x = p + f (w (v x p) + v x (v x p)) + T clamp(s)
    const float a0 = sub(mul(vy, p2), mul(vz, p1));
    const float a1 = sub(mul(vz, p0), mul(vx, p2));
    const float a2 = sub(mul(vx, p1), mul(vy, p0));
    const float b0 = sub(mul(vy, a2), mul(vz, a1));
    const float b1 = sub(mul(vz, a0), mul(vx, a2));
    const float b2 = sub(mul(vx, a1), mul(vy, a0));
    const float r0 = add(mul(w, a0), b0), r1 = add(mul(w, a1), b1), r2 = add(mul(w, a2), b2);
    const float x0 = add(add(p0, mul(f, r0)), tx);
    const float x1 = add(add(p1, mul(f, r1)), ty);
    const float x2 = add(add(p2, mul(f, r2)), tz);
    const float pa = dot(k[0], k[1], k[2], x0, x1, x2);
    const float pb = dot(k[3], k[4], k[5], x0, x1, x2);
    const float pc = dot(k[6], k[7], k[8], x0, x1, x2);
    const float rc = __frcp_rn(pc);
    const float u = mul(pa, rc), v = mul(pb, rc);
    const float ru = sub(u, tu), rv = sub(v, tv);
    loss = add(add(loss, fabsf(ru)), fabsf(rv));
    const float eu = l1_sign(ru, a.weight), ev = l1_sign(rv, a.weight);
    // dL/dx through the projection (a / c, b / c)
    const float ga = mul(eu, rc), gb = mul(ev, rc);
    const float gc = -mul(add(mul(eu, u), mul(ev, v)), rc);
    const float g0 = add(add(mul(ga, k[0]), mul(gb, k[3])), mul(gc, k[6]));
    const float g1 = add(add(mul(ga, k[1]), mul(gb, k[4])), mul(gc, k[7]));
    const float g2 = add(add(mul(ga, k[2]), mul(gb, k[5])), mul(gc, k[8]));
    sg0 = add(sg0, g0);
    sg1 = add(sg1, g1);
    sg2 = add(sg2, g2);
    gr = add(gr, dot(g0, g1, g2, r0, r1, r2));
    gc1 = add(gc1, dot(g0, g1, g2, a0, a1, a2));
    // d/dv of G.(w (v x p) + v (v.p) - p |v|^2) at fixed f
    const float vp = dot(vx, vy, vz, p0, p1, p2);
    const float gv = dot(g0, g1, g2, vx, vy, vz);
    const float gp2 = mul(dot(g0, g1, g2, p0, p1, p2), 2.f);
    const float q0 = sub(mul(p1, g2), mul(p2, g1));
    const float q1 = sub(mul(p2, g0), mul(p0, g2));
    const float q2 = sub(mul(p0, g1), mul(p1, g0));
    gv0 = add(gv0, sub(add(add(mul(w, q0), mul(g0, vp)), mul(p0, gv)), mul(gp2, vx)));
    gv1 = add(gv1, sub(add(add(mul(w, q1), mul(g1, vp)), mul(p1, gv)), mul(gp2, vy)));
    gv2 = add(gv2, sub(add(add(mul(w, q2), mul(g2, vp)), mul(p2, gv)), mul(gp2, vz)));
  }
  sg0 = lane_sum(sg0);
  sg1 = lane_sum(sg1);
  sg2 = lane_sum(sg2);
  gr = lane_sum(gr);
  gc1 = lane_sum(gc1);
  gv0 = lane_sum(gv0);
  gv1 = lane_sum(gv1);
  gv2 = lane_sum(gv2);
  loss = lane_sum(loss);
  if (row >= a.rows) return;

  // f = 2 / |q|^2: df/dq = -(2 q) f / |q|^2
  const float m2 = mul(mul(mul(gr, f), rn), 2.f);
  if (own.p) {
    const float value = lane == 0 ? w : (lane == 1 ? vx : (lane == 2 ? vy : vz));
    const float dv = lane == 0 ? gc1 : (lane == 1 ? gv0 : (lane == 2 ? gv1 : gv2));
    adam(own, r, value, own_m, own_v, sub(mul(f, dv), mul(m2, value)), c1, c2, a);
  }
  if (lane == 0) {
    const bool inside = s >= a.lo && s <= a.hi;
    adam(a.s, r, s, s_m, s_v, inside ? dot(sg0, sg1, sg2, t0, t1, t2) : 0.f, c1, c2, a);
    a.row_loss[r] = loss;
  }
}

}  // namespace

extern "C" {

// One IPO Adam step of every row, in place: consts [5 * keys + 12, rows] f32;
// each leaf's value p, Adam moments m and v [rows] f32 (x, y, z null where the
// axis is not learned); corrections [iterations, 2] f32 (the reciprocals of
// Adam's bias corrections), read at *counter; row_loss [rows] f32, written.
// Scalars: the loss weight 1 / (rows a group x keys x 2), the learning rate,
// the scale's clamp, Adam's b1, 1 - b1, b2, 1 - b2 and eps. Nothing here
// allocates or synchronises. Returns the first CUDA error, or 0.
int zedo_ipo_step(const float* consts, int rows, int keys, float* w, float* w_m, float* w_v,
                  float* x, float* x_m, float* x_v, float* y, float* y_m, float* y_v, float* z,
                  float* z_m, float* z_v, float* s, float* s_m, float* s_v,
                  const float* corrections, const int64_t* counter, float* row_loss,
                  float weight, float lr, float lo, float hi, float b1, float one_minus_b1,
                  float b2, float one_minus_b2, float eps, void* stream) {
  if (rows < 0 || keys < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const StepArgs a{consts, rows, keys, {w, w_m, w_v}, {x, x_m, x_v}, {y, y_m, y_v},
                   {z, z_m, z_v}, {s, s_m, s_v}, corrections, counter, row_loss, weight, lr,
                   lo, hi, b1, one_minus_b1, b2, one_minus_b2, eps};
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  ipo_step<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
