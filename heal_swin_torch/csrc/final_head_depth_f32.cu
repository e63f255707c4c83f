// The f32 decoder tail's entries for depth: K8 (the masked depth loss) and K9 (its
// backward); the kernels are in tail_f32.cuh, the segmentation entries in final_head_f32.cu.

#include "tail_f32.cuh"

extern "C" {

size_t hs_final_head_depth_loss_f32_smem(int C, int F, int P) {
  (void)P;
  return hs::f32_layout(C, hs::nf_of(F, true), F, hs::kF32Depth).total;
}

size_t hs_final_head_depth_loss_bwd_f32_smem(int C, int F, int P) {
  (void)P;
  return hs::f32_layout(C, hs::nf_of(F, true), F, hs::kF32DepthBwd).total;
}

// f32 K8's and K9's row kernels' grids (0 where they do not take the shape)
int hs_final_head_depth_loss_f32_grid(int T, int C, int F, int P) {
  (void)P;
  return hs::f32_grid_of<hs::DepthLoss, false>(T, C, F);
}

int hs_final_head_depth_loss_bwd_f32_grid(int T, int C, int F, int P) {
  (void)P;
  return hs::f32_grid_of<hs::DepthLoss, true>(T, C, F);
}

size_t hs_final_head_depth_loss_f32_workspace(int T, int C, int F, int P) {
  (void)P;
  return hs::f32_loss_workspace<hs::DepthLoss>(T, C, F);
}

size_t hs_final_head_depth_loss_bwd_f32_workspace(int T, int C, int F, int P) {
  return hs::f32_bwd_work<hs::DepthLoss>(T, C, F, P).total;
}

// f32 K8: red = [sum loss, count of valid targets], preds (T, p F) f32 the logits; the
// loss of kind (l2, l1, huber, nll: 0-3; nll needs F = 2); tap (may be null) gets the
// logits (T, p, F) too
int hs_final_head_depth_loss_f32(const void* x, const void* we, const void* gamma,
                                 const void* beta, const void* wh, const void* t, void* red,
                                 void* preds, void* work, void* tap, int T, int C, int F, int P,
                                 int kind, float eps, float delta, void* stream) {
  hs::DepthLoss loss;
  if (!hs::depth_loss_of(t, preds, kind, delta, F, &loss)) return int(cudaErrorInvalidValue);
  return int(hs::launch_f32_loss(x, we, gamma, beta, wh, loss, red, work, tap, T, C, F, P, eps,
                                 static_cast<cudaStream_t>(stream)));
}

// f32 K9's row kernel alone: dx, dh and its partial rows as f32 K7's; tap as K8's
int hs_final_head_depth_loss_bwd_f32_rows(const void* x, const void* we, const void* gamma,
                                          const void* beta, const void* wh, const void* t,
                                          const void* scale, void* dx, void* dh, void* part,
                                          void* tap, int T, int C, int F, int P, int kind,
                                          float eps, float delta, void* stream) {
  hs::DepthLoss loss;
  if (!hs::depth_loss_of(t, nullptr, kind, delta, F, &loss)) return int(cudaErrorInvalidValue);
  return int(hs::launch_f32_bwd_rows(x, we, gamma, beta, wh, loss, scale, dx, dh, part, tap, T,
                                     C, F, P, eps, static_cast<cudaStream_t>(stream)));
}

// f32 K9: the row kernel, reduce_rows, gemm_tn_f32; red = [dWh | dgamma | dbeta]
int hs_final_head_depth_loss_bwd_f32(const void* x, const void* we, const void* gamma,
                                     const void* beta, const void* wh, const void* t,
                                     const void* scale, void* dx, void* dwe, void* red,
                                     void* work, int T, int C, int F, int P, int kind,
                                     float eps, float delta, void* stream) {
  hs::DepthLoss loss;
  if (!hs::depth_loss_of(t, nullptr, kind, delta, F, &loss)) return int(cudaErrorInvalidValue);
  return int(hs::launch_f32_bwd(x, we, gamma, beta, wh, loss, scale, dx, dwe, red, work, T, C,
                                F, P, eps, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
