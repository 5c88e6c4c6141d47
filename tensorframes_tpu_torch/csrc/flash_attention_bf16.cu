// The blockwise attention kernels on bfloat16 inputs: the tensor-core
// kernel (flash_attention_tc.cuh) at padded head widths up to 128, the wide
// CUDA-core kernel (flash_attention.cuh) past it; the C entries
// tfs_flash_attention_bf16 and tfs_flash_attention_lse_bf16.
#include "flash_attention.cuh"
#include "flash_attention_tc.cuh"

TFS_ATTENTION_ENTRIES(__nv_bfloat16, bf16)
