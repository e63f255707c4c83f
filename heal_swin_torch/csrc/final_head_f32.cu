// The f32 decoder tail's entries for segmentation: K3 (predict), K6 and K7 (the weighted
// cross entropy and its backward); the kernels are in tail_f32.cuh, the depth entries (K8,
// K9) in final_head_depth_f32.cu.

#include "tail_f32.cuh"

extern "C" {

size_t hs_final_head_predict_f32_smem(int C, int F, int P) {
  (void)P;
  return hs::f32_layout(C, hs::nf_of(F, false), F, hs::kF32Pred).total;
}

// f32 K3: preds (T, p) int32, the argmax of each element's f32 logits (lowest index at
// the max, F - 1 for a row holding a NaN); tap (may be null) gets the logits (T, p, F)
int hs_final_head_predict_f32(const void* x, const void* we, const void* gamma,
                              const void* beta, const void* wh, void* preds, void* tap, int T,
                              int C, int F, int P, float eps, void* stream) {
  return int(hs::launch_f32_pred(x, we, gamma, beta, wh, preds, tap, T, C, F, P, eps,
                                 static_cast<cudaStream_t>(stream)));
}

size_t hs_final_head_loss_f32_smem(int C, int F, int P) {
  (void)P;
  return hs::f32_layout(C, hs::nf_of(F, false), F, hs::kF32Ce).total;
}

size_t hs_final_head_loss_bwd_f32_smem(int C, int F, int P) {
  (void)P;
  return hs::f32_layout(C, hs::nf_of(F, false), F, hs::kF32CeBwd).total;
}

// f32 K6's and K7's tile kernels' grids (0 where they do not take the shape)
int hs_final_head_loss_f32_grid(int T, int C, int F, int P) {
  (void)P;
  return hs::f32_grid_of<hs::CeLoss, false>(T, C, F);
}

int hs_final_head_loss_bwd_f32_grid(int T, int C, int F, int P) {
  (void)P;
  return hs::f32_grid_of<hs::CeLoss, true>(T, C, F);
}

size_t hs_final_head_loss_f32_workspace(int T, int C, int F, int P) {
  (void)P;
  return hs::f32_loss_workspace<hs::CeLoss>(T, C, F);
}

size_t hs_final_head_loss_bwd_f32_workspace(int T, int C, int F, int P) {
  return hs::f32_bwd_work<hs::CeLoss>(T, C, F, P).total;
}

// f32 K6: red = [sum w*nll, sum w, confusion matrix]; tap (may be null) gets the f32
// logits (T, p, F)
int hs_final_head_loss_f32(const void* x, const void* we, const void* gamma, const void* beta,
                           const void* wh, const void* y, const void* welem, void* red,
                           void* work, void* tap, int T, int C, int F, int P, float eps,
                           void* stream) {
  return int(hs::launch_f32_loss(x, we, gamma, beta, wh, hs::ce_loss(y, welem), red, work, tap,
                                 T, C, F, P, eps, static_cast<cudaStream_t>(stream)));
}

// f32 K7's tile kernel alone: dx (T x C) and its partial rows
// (hs_final_head_loss_bwd_f32_grid rows of p C^2 + C F + 2C floats: dWe (C x p C) | dWh |
// dgamma | dbeta), all f32; tap as K6's
int hs_final_head_loss_bwd_f32_rows(const void* x, const void* we, const void* gamma,
                                    const void* beta, const void* wh, const void* y,
                                    const void* welem, const void* scale, void* dx,
                                    void* part, void* tap, int T, int C, int F, int P,
                                    float eps, void* stream) {
  return int(hs::launch_f32_bwd_rows(x, we, gamma, beta, wh, hs::ce_loss(y, welem), scale, dx,
                                     part, tap, T, C, F, P, eps,
                                     static_cast<cudaStream_t>(stream)));
}

// f32 K7: the tile kernel, then reduce_rows; red = [dWe (C x p C) | dWh | dgamma | dbeta]
int hs_final_head_loss_bwd_f32(const void* x, const void* we, const void* gamma,
                               const void* beta, const void* wh, const void* y,
                               const void* welem, const void* scale, void* dx, void* red,
                               void* work, int T, int C, int F, int P, float eps,
                               void* stream) {
  return int(hs::launch_f32_bwd(x, we, gamma, beta, wh, hs::ce_loss(y, welem), scale, dx, red,
                                work, T, C, F, P, eps, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
