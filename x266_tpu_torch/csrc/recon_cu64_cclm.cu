// The recon kernels' CU-64 instances with CCLM (csrc/recon_intra.cu, kC64
// and kCc, with and without LFNST), compiled apart from csrc/recon_cu64.cu's
// so that the two build at once; reached through x266_recon_cu64_cclm.
#define X266_RECON_CU64_CCLM_PART
#include "recon_intra.cu"
