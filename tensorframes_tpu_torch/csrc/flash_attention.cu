// The blockwise attention kernel (flash_attention.cuh) on float32 inputs:
// the C entries tfs_flash_attention_f32 and tfs_flash_attention_lse_f32.
#include "flash_attention.cuh"

TFS_ATTENTION_ENTRIES(float, f32)
