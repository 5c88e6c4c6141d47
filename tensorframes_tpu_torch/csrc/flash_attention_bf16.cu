// The blockwise attention kernel (flash_attention.cuh) on bfloat16 inputs:
// the C entries tfs_flash_attention_bf16 and tfs_flash_attention_lse_bf16.
#include "flash_attention.cuh"

TFS_ATTENTION_ENTRIES(__nv_bfloat16, bf16)
