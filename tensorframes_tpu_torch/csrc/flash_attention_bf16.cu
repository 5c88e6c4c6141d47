// The blockwise attention kernels on bfloat16 inputs: the tensor-core
// kernels (flash_attention_tc.cuh) at every padded head width, one block
// for up to 256 columns, slices of output columns past it; the dispatch
// and the C entries tfs_flash_attention_bf16 and tfs_flash_attention_lse_bf16
// (flash_attention.cuh).
#include "flash_attention.cuh"
#include "flash_attention_tc.cuh"

TFS_ATTENTION_ENTRIES(__nv_bfloat16, bf16)
