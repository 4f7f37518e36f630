// The branch-free reciprocal of the ray-triangle tests, shared by the block
// tracer (K1, trace_blocks.cu), the resident tracer (K2, resident.cu) and
// the fused frame kernel (K4, fused.cu).
//
// rcp_rn(x) is 1.0f / x rounded as IEEE division rounds it, for |x| in
// [kRcpLo, kRcpHi): an approximate reciprocal and one Newton step, three
// instructions and no branch.  The division gives the same value through a
// range check, a branch and a slow-path call, which make every test that
// divides a basic block of its own that the scheduler cannot overlap with
// the next.  pbr_rcp_check (trace_blocks.cu) compares rcp_rn with 1.0f / x
// on every float of that range (chip_smoke.py phase 4); above kRcpHi,
// where 1 / x is subnormal, the flushed approximation gives 0 and is not
// used: a caller that meets |x| >= kRcpHi divides instead.

#pragma once

namespace pbr {

constexpr float kRcpLo = 1e-9f;
constexpr float kRcpHi = 0x1p126f;

__device__ __forceinline__ float rcp_rn(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return __fmaf_rn(r, __fmaf_rn(-x, r, 1.0f), r);
}

}  // namespace pbr
