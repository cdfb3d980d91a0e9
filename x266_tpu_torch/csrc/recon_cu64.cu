// The recon kernels' CU-64 instances without CCLM (csrc/recon_intra.cu,
// kC64: K1 and K2 with the 64-point DCT and its zero-out, with and without
// LFNST), compiled apart from the others so that those compile as they did
// without them and the parts build at once; csrc/recon_intra.cu's
// x266_recon_intra reaches them through x266_recon_cu64, which hands a
// CCLM launch to csrc/recon_cu64_cclm.cu.
#define X266_RECON_CU64_PART
#include "recon_intra.cu"
