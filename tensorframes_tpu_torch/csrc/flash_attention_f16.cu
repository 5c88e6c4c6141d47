// The blockwise attention kernel (flash_attention.cuh) on float16 inputs:
// the C entries tfs_flash_attention_f16 and tfs_flash_attention_lse_f16.
#include "flash_attention.cuh"

TFS_ATTENTION_ENTRIES(__half, f16)
