// Launch attributes of every kernel instantiation, read from the library.
//
// Not a kernel: two launchers that report what the compiled library holds,
// so that a check on the card can hold each instantiation against its
// symbolic spec (kernels/specs.py) and against the card's limits.
//   hsz_func_attrs   static shared memory (cudaFuncGetAttributes), the
//                    dynamic shared memory its launcher asks for, registers
//                    per thread and resident blocks per SM (occupancy API)
//   hsz_smem_optin   the card's shared-memory limit per block
//                    (cudaDevAttrMaxSharedMemoryPerBlockOptin)
// Kernel ids run over the sources' tables in the order below, which is the
// order of specs.KERNEL_IDS (the audit checks both).
#include "common.cuh"

namespace {

const hsz::KernelTable* const TABLES[] = {
    &hsz::pack_kernels,   &hsz::quant_lorenzo_kernels, &hsz::block_stats_kernels,
    &hsz::stencil_dq_kernels, &hsz::unpack_kernels,    &hsz::lorenzo_kernels,
    &hsz::blockmean_kernels, &hsz::lorenzo3d_kernels,
};

const hsz::KernelInfo* info_of(int id) {
  if (id < 0) return nullptr;
  for (const hsz::KernelTable* t : TABLES) {
    if (id < t->n) return t->info + id;
    id -= t->n;
  }
  return nullptr;
}

}  // namespace

// Static and dynamic shared memory (bytes), registers per thread and
// resident blocks per SM of kernel `kernel_id`.
extern "C" int hsz_func_attrs(int kernel_id, int* static_smem, int* dynamic_smem, int* regs,
                              int* blocks_per_sm) {
  const hsz::KernelInfo* k = info_of(kernel_id);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k->fn);
  // above 48 KB a block's dynamic shared memory must be allowed first, as
  // the kernel's own launcher does
  if (err == cudaSuccess && k->dynamic_smem > 48 * 1024)
    err = cudaFuncSetAttribute(k->fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               k->dynamic_smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k->fn, k->threads,
                                                        k->dynamic_smem);
  if (err != cudaSuccess) return (int)err;
  *static_smem = (int)fa.sharedSizeBytes;
  *dynamic_smem = k->dynamic_smem;
  *regs = fa.numRegs;
  *blocks_per_sm = per_sm;
  return 0;
}

// The card's shared memory per block with the opt-in (bytes).
extern "C" int hsz_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}
