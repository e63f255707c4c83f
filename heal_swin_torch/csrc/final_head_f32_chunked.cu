// The f32 decoder tail's K3, K6 and K7 for heads above 16 classes (up to 128 where a
// block's shared memory holds them): tail_f32.cuh's kernels with NF 0, the head in chunks
// of 16 columns, compiled in this unit of their own so that nvcc builds them beside the
// fixed heads' (final_head_f32.cu, whose entries forward here for F > 16).

#include "tail_f32.cuh"

extern "C" {

int hs_final_head_predict_f32_chunked(const void* x, const void* we, const void* gamma,
                                      const void* beta, const void* wh, void* preds, void* tap,
                                      int T, int C, int F, int P, float eps, void* stream) {
  return int(hs::launch_f32_pred<true>(x, we, gamma, beta, wh, preds, tap, T, C, F, P, eps,
                                       static_cast<cudaStream_t>(stream)));
}

int hs_final_head_loss_f32_chunked_grid(int T, int C, int F, int P) {
  (void)P;
  return hs::f32_grid_of<hs::CeLoss, false, true>(T, C, F);
}

int hs_final_head_loss_bwd_f32_chunked_grid(int T, int C, int F, int P) {
  (void)P;
  return hs::f32_grid_of<hs::CeLoss, true, true>(T, C, F);
}

size_t hs_final_head_loss_f32_chunked_workspace(int T, int C, int F, int P) {
  (void)P;
  return hs::f32_loss_workspace<hs::CeLoss, true>(T, C, F);
}

size_t hs_final_head_loss_bwd_f32_chunked_workspace(int T, int C, int F, int P) {
  return hs::f32_bwd_work<hs::CeLoss, true>(T, C, F, P).total;
}

int hs_final_head_loss_f32_chunked(const void* x, const void* we, const void* gamma,
                                   const void* beta, const void* wh, const void* y,
                                   const void* welem, void* red, void* work, void* tap, int T,
                                   int C, int F, int P, float eps, void* stream) {
  return int(hs::launch_f32_loss<hs::CeLoss, true>(x, we, gamma, beta, wh,
                                                   hs::ce_loss(y, welem), red, work, tap, T, C,
                                                   F, P, eps,
                                                   static_cast<cudaStream_t>(stream)));
}

int hs_final_head_loss_bwd_f32_chunked_rows(const void* x, const void* we, const void* gamma,
                                            const void* beta, const void* wh, const void* y,
                                            const void* welem, const void* scale, void* dx,
                                            void* part, void* tap, int T, int C, int F, int P,
                                            float eps, void* stream) {
  return int(hs::launch_f32_bwd_rows<hs::CeLoss, true>(
      x, we, gamma, beta, wh, hs::ce_loss(y, welem), scale, dx, part, tap, T, C, F, P, eps,
      static_cast<cudaStream_t>(stream)));
}

int hs_final_head_loss_bwd_f32_chunked(const void* x, const void* we, const void* gamma,
                                       const void* beta, const void* wh, const void* y,
                                       const void* welem, const void* scale, void* dx,
                                       void* red, void* work, int T, int C, int F, int P,
                                       float eps, void* stream) {
  return int(hs::launch_f32_bwd<hs::CeLoss, true>(x, we, gamma, beta, wh, hs::ce_loss(y, welem),
                                                  scale, dx, red, work, T, C, F, P, eps,
                                                  static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
