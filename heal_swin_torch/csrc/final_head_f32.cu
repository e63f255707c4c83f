// The f32 decoder tail's entries for segmentation: K3 (predict), K6 and K7 (the weighted
// cross entropy and its backward), and gemm_tn_f32 alone; the kernels are in tail_f32.cuh,
// the depth entries (K8, K9) in final_head_depth_f32.cu.

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

// f32 K6's and K7's row kernels' grids (0 where they do not take the shape)
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

// f32 K7's row kernel alone: dx (T x C), dh (T x p C) and its partial rows
// (hs_final_head_loss_bwd_f32_grid rows of C F + 2C floats: dWh | dgamma | dbeta), all
// f32; tap as K6's
int hs_final_head_loss_bwd_f32_rows(const void* x, const void* we, const void* gamma,
                                    const void* beta, const void* wh, const void* y,
                                    const void* welem, const void* scale, void* dx, void* dh,
                                    void* part, void* tap, int T, int C, int F, int P,
                                    float eps, void* stream) {
  return int(hs::launch_f32_bwd_rows(x, we, gamma, beta, wh, hs::ce_loss(y, welem), scale, dx,
                                     dh, part, tap, T, C, F, P, eps,
                                     static_cast<cudaStream_t>(stream)));
}

// f32 K7: the row kernel, reduce_rows, gemm_tn_f32; red = [dWh | dgamma | dbeta]
int hs_final_head_loss_bwd_f32(const void* x, const void* we, const void* gamma,
                               const void* beta, const void* wh, const void* y,
                               const void* welem, const void* scale, void* dx, void* dwe,
                               void* red, void* work, int T, int C, int F, int P, float eps,
                               void* stream) {
  return int(hs::launch_f32_bwd(x, we, gamma, beta, wh, hs::ce_loss(y, welem), scale, dx, dwe,
                                red, work, T, C, F, P, eps, static_cast<cudaStream_t>(stream)));
}

// out (M x N f32) = A^T B over K rows: A (K x M), B (K x N) f32, K % 16, M % 4, N % 4;
// work holds hs_gemm_tn_f32_workspace bytes
size_t hs_gemm_tn_f32_workspace(int K, int M, int N) {
  return hs::gemm_tn_f32_tmp_floats(K, M, N) * 4;
}

int hs_gemm_tn_f32(const void* A, const void* B, void* out, void* work, int K, int M, int N,
                   void* stream) {
  return int(hs::gemm_tn_f32(static_cast<const float*>(A), static_cast<const float*>(B),
                             static_cast<float*>(out), K, M, N, static_cast<float*>(work),
                             static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
