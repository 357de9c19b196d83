// Cell math of the binary IRT links, shared by the loglik kernels
// (loglik_train.cu, masked_loglik.cu): each kernel is templated on one of
// these functors.
//
// A link stages NP per-item constants (p[0] is always the difficulty b) in
// shared memory once per item tile, not once per cell, and adds NX per-item
// gradients beside da and db. A cell's logit is l = theta_i . a_j - p[0].
//
// Link2PL: p = sigmoid(l), the math of the Pallas 2PL bodies
// (vibo_tpu/ops/pallas_elbo.py :229, :278, :296, :1183); sigmoid(l) is
// 1/(1+e) for l >= 0 and e/(1+e) below, e = exp(-|l|).
//
// Link3PL: pi = g + (1 - g) sigmoid(l), g = sigmoid(g_hat), in log space as
// _cell_3pl / _dcell_3pl (pallas_elbo.py :835-854). Per item, staged:
//   log g = -softplus(-g_hat),  log(1-g) = -softplus(g_hat),  g
// Per cell:
//   e = exp(-|l|), lp = log1p(e)
//   softplus(l) = lp + max(l, 0),  softplus(-l) = lp - min(l, 0)
//   log_s     = log(1-g) - softplus(-l)        (log of (1-g) sigmoid(l))
//   log(1-pi) = log(1-g) - softplus(l)
//   log pi    = logaddexp(log g, log_s) = max + log1p(t),
//               t = exp(-|log g - log_s|)
//   ll = m (r log pi + (1-r) log(1-pi))
// Gradients through the branch ratios ratio_s = (1-g) s / pi and
// ratio_g = g / pi, s = sigmoid(l), which sum to 1: the larger is 1/(1+t)
// and the smaller t/(1+t), both from the t already computed for log pi, so
// neither loses its relative precision when it is tiny and no exp is spent:
//   dl  = m (r ratio_s (1-s) - (1-r) s)
//   dgh = m (r ratio_g (1-g) (1-s) - (1-r) g)
// (1-s) is taken from e as well, exact where s rounds to 1. Every term is
// finite for finite inputs, so a cell with m = 0 contributes exactly 0.

#pragma once

#include <cuda_runtime.h>

namespace vibo {

// The special-function unit's approximations: 2^x, 1/x and log2 x, each
// within a few ulp (log2 within ~1e-7 absolute on [1, 2]), denormals
// flushed to zero.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

struct Link2PL {
  static constexpr int NP = 1;  // staged per item: b
  static constexpr int NX = 0;  // item gradients beside da and db

  __device__ __forceinline__ static void stage(float b, float,
                                               float (&p)[NP]) {
    p[0] = b;
  }

  // One-pass training cell on the int8 code (r in {0, 1}): returns ll and
  // sets dl (dx unused).
  __device__ __forceinline__ static float train(float l, const float (&)[NP],
                                                float mk, float r, float& dl,
                                                float& dx) {
    const float e = expf(-fabsf(l));
    const float sp = log1pf(e) + fmaxf(l, 0.f);
    const float inv = 1.f / (1.f + e);
    const float sg = l >= 0.f ? inv : e * inv;
    dl = mk * (r - sg);
    dx = 0.f;
    return -mk * (r > 0.5f ? sp - l : sp);
  }

  // General op, value: m (r l - softplus(l)), r any value in [0, 1].
  // log1p(e) = log2(1 + e) ln 2 with 1 + e in [1, 2], where lg2_approx is
  // within ~1e-7 absolute, as close as log1pf is to f32 over a row's sum.
  __device__ __forceinline__ static float value(float l, const float (&)[NP],
                                                float mk, float r) {
    const float e = ex2_approx(fabsf(l) * -LOG2E);
    return mk * ((r * l - fmaxf(l, 0.f)) - lg2_approx(1.f + e) * LN2);
  }

  // General op, gradient for a unit cotangent: returns dl (dx unused).
  __device__ __forceinline__ static float grad(float l, const float (&)[NP],
                                               float mk, float r, float& dx) {
    const float e = expf(-fabsf(l));
    const float inv = 1.f / (1.f + e);
    const float sg = l >= 0.f ? inv : e * inv;
    dx = 0.f;
    return mk * (r - sg);
  }
};

struct Link3PL {
  static constexpr int NP = 4;  // staged per item: b, log g, log(1-g), g
  static constexpr int NX = 1;  // item gradient beside da and db: dg_hat

  __device__ __forceinline__ static void stage(float b, float gh,
                                               float (&p)[NP]) {
    const float e = expf(-fabsf(gh));
    const float lp = log1pf(e);
    const float inv = 1.f / (1.f + e);
    p[0] = b;
    p[1] = -(lp + fmaxf(-gh, 0.f));       // log g
    p[2] = -(lp + fmaxf(gh, 0.f));        // log(1 - g)
    p[3] = gh >= 0.f ? inv : e * inv;     // g
  }

  // Everything of one cell both directions share.
  struct Cell {
    float e, log_pi, log_1m_pi, t;
    bool g_larger;  // log g >= log_s: ratio_g is the larger ratio
  };

  __device__ __forceinline__ static Cell cell(float l, const float (&p)[NP]) {
    Cell c;
    c.e = expf(-fabsf(l));
    const float lp = log1pf(c.e);
    const float log_s = p[2] - (lp - fminf(l, 0.f));
    c.log_1m_pi = p[2] - (lp + fmaxf(l, 0.f));
    c.g_larger = p[1] >= log_s;
    const float hi = c.g_larger ? p[1] : log_s;
    const float lo = c.g_larger ? log_s : p[1];
    c.t = expf(lo - hi);
    c.log_pi = hi + log1pf(c.t);
    return c;
  }

  __device__ __forceinline__ static float cell_value(const Cell& c, float mk,
                                                     float r) {
    return mk * (r * c.log_pi + (1.f - r) * c.log_1m_pi);
  }

  // (dl, dg_hat) of one cell for a unit cotangent.
  __device__ __forceinline__ static float cell_grad(const Cell& c, float l,
                                                    const float (&p)[NP],
                                                    float mk, float r,
                                                    float& dx) {
    const float inv = 1.f / (1.f + c.e);
    const float sg = l >= 0.f ? inv : c.e * inv;     // sigmoid(l)
    const float om = l >= 0.f ? c.e * inv : inv;     // 1 - sigmoid(l)
    const float big = 1.f / (1.f + c.t);
    const float small = c.t * big;
    const float ratio_g = c.g_larger ? big : small;
    const float ratio_s = c.g_larger ? small : big;
    const float g = p[3];
    dx = mk * (r * ratio_g * (1.f - g) * om - (1.f - r) * g);
    return mk * (r * ratio_s * om - (1.f - r) * sg);
  }

  __device__ __forceinline__ static float train(float l, const float (&p)[NP],
                                                float mk, float r, float& dl,
                                                float& dx) {
    const Cell c = cell(l, p);
    dl = cell_grad(c, l, p, mk, r, dx);
    return cell_value(c, mk, r);
  }

  __device__ __forceinline__ static float value(float l, const float (&p)[NP],
                                                float mk, float r) {
    return cell_value(cell(l, p), mk, r);
  }

  __device__ __forceinline__ static float grad(float l, const float (&p)[NP],
                                               float mk, float r, float& dx) {
    return cell_grad(cell(l, p), l, p, mk, r, dx);
  }
};

}  // namespace vibo
