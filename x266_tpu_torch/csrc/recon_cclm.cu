// The recon kernels' CCLM instances (csrc/recon_intra.cu, kCc: K1 and K2
// with each quantizer), compiled apart from the others so that those
// compile as they did without them and the three parts build at once;
// csrc/recon_intra.cu's x266_recon_intra reaches them through
// x266_recon_cclm.
#define X266_RECON_CCLM_PART
#include "recon_intra.cu"
