// x266t native entropy engine (C3/C4): adaptive binary range coder +
// full picture syntax walker.  Bit-for-bit mirror of the Python reference
// in ../engine.py and ../syntax.py (differential-tested); C++ because the
// serial bin loop is the one codec component that cannot be a TPU kernel
// (SURVEY.md §1.1) and the reference's entropy layer is native C [B:5].
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in image).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int PROB_BITS = 12;
constexpr int PROB_MAX = 1 << PROB_BITS;
constexpr int PROB_INIT = PROB_MAX / 2;
constexpr int PROB_MIN = 16;
constexpr int RATE_FAST = 4;
constexpr int RATE_SLOW = 7;
constexpr uint32_t TOP = 1u << 24;

// ---- context registry (mirror of contexts.py) ----------------------------
constexpr int CTX_SPLIT = 0;
constexpr int CTX_MPM_FLAG = 2;
constexpr int CTX_CBF_Y = 3;
constexpr int CTX_CBF_C = 5;
constexpr int CTX_LAST_X = 7;
constexpr int CTX_LAST_Y = 27;
constexpr int CTX_CSBF = 47;
constexpr int CTX_SIG = 51;
constexpr int CTX_GT1 = 69;
constexpr int CTX_GT2 = 73;
constexpr int CTX_SAO_ON = 75;
constexpr int CTX_SAO_KIND = 76;
constexpr int CTX_MTS = 77;
constexpr int CTX_SKIP = 78;
constexpr int CTX_PRED_MODE = 79;
constexpr int CTX_MVD_GT0 = 80;
constexpr int CTX_BLIST = 82;
constexpr int CTX_TS_FLAG = 84;   // transform_skip_flag (C10)
constexpr int CTX_MERGE_IDX = 85; // skip merge candidate index (C7)
constexpr int CTX_CCLM = 86;      // chroma CCLM vs DM (C6, I slices)
constexpr int CTX_BT_FLAG = 87;   // MTT binary split (C5): [32, 16]
constexpr int CTX_BT_DIR = 89;    // split direction (1 = BT-V)
constexpr int CTX_LFNST = 90;     // lfnst_idx > 0 (C10, I slices)
constexpr int CTX_MIP = 91;       // matrix intra pred flag (C6)
constexpr int CTX_AMVP_MERGE = 92;  // merge-with-residual flag (C7)
constexpr int CTX_AMVP_IDX = 93;    // AMVP predictor index (C7)
constexpr int NUM_CONTEXTS = 94;

const int MIN_IN_GROUP[10] = {0, 1, 2, 3, 4, 6, 8, 12, 16, 24};

int group_idx(int v) {
  if (v < 4) return v;
  int k = 31 - __builtin_clz((unsigned)v);
  return 2 * k + ((v >> (k - 1)) & 1);
}
int group_suffix_bits(int g) { return g >= 4 ? (g >> 1) - 1 : 0; }
int max_group(int size) { return group_idx(size - 1); }

// ---- adaptive contexts ----------------------------------------------------
struct Contexts {
  int32_t pf[NUM_CONTEXTS];
  int32_t ps[NUM_CONTEXTS];
  Contexts() {
    for (int i = 0; i < NUM_CONTEXTS; i++) pf[i] = ps[i] = PROB_INIT;
  }
  // trained init tables (cabac/ctx_init.py): t = [pf[0..n), ps[0..n)]
  void load(const int32_t* t) {
    for (int i = 0; i < NUM_CONTEXTS; i++) {
      pf[i] = t[i];
      ps[i] = t[NUM_CONTEXTS + i];
    }
  }
  // WPP context inheritance (P6, round-5): snapshot in load() layout
  void store(int32_t* t) const {
    for (int i = 0; i < NUM_CONTEXTS; i++) {
      t[i] = pf[i];
      t[NUM_CONTEXTS + i] = ps[i];
    }
  }
  int prob(int idx) const {
    int p = (pf[idx] + ps[idx]) >> 1;
    if (p < PROB_MIN) p = PROB_MIN;
    if (p > PROB_MAX - PROB_MIN) p = PROB_MAX - PROB_MIN;
    return p;
  }
  void update(int idx, int bin) {
    int target = bin ? PROB_MAX : 0;
    pf[idx] += (target - pf[idx]) >> RATE_FAST;   // arithmetic shift
    ps[idx] += (target - ps[idx]) >> RATE_SLOW;
  }
};

// ---- range encoder (LZMA-class renorm; mirror of engine.py) ---------------
struct Encoder {
  uint64_t low = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint32_t cache = 0;
  int64_t cache_size = 1;
  std::vector<uint8_t> out;

  void shift_low() {
    if ((uint32_t)low < 0xFF000000u || (low >> 32) != 0) {
      uint32_t carry = (uint32_t)(low >> 32);
      out.push_back((uint8_t)(cache + carry));
      for (int64_t i = 0; i < cache_size - 1; i++)
        out.push_back((uint8_t)(0xFF + carry));
      cache_size = 0;
      cache = (uint8_t)(low >> 24);
    }
    cache_size++;
    low = (uint32_t)low << 8;   // mask to 32 bits, then shift (drops 24-31)
    low &= 0xFFFFFFFFu;
  }
  void renorm() {
    while (range < TOP) {
      shift_low();
      range <<= 8;
    }
  }
  void encode_bin(Contexts& c, int idx, int bin) {
    uint32_t bound = (range >> PROB_BITS) * (uint32_t)c.prob(idx);
    if (bin) {
      range = bound;
    } else {
      low += bound;
      range -= bound;
    }
    c.update(idx, bin);
    renorm();
  }
  void encode_bypass(int bin) {
    range >>= 1;
    if (!bin) low += range;
    renorm();
  }
  void encode_bypass_bits(uint32_t v, int n) {
    for (int k = n - 1; k >= 0; k--) encode_bypass((v >> k) & 1);
  }
  // finish: 5 shift_lows, drop leading zero byte
  void finish() {
    for (int i = 0; i < 5; i++) shift_low();
  }
};

// ---- range decoder --------------------------------------------------------
struct Decoder {
  const uint8_t* data;
  int64_t len;       // includes virtual padding handled in next_byte()
  int64_t pos = 0;   // index into payload (leading 0 byte is virtual)
  uint32_t range = 0xFFFFFFFFu;
  uint32_t code = 0;
  bool error = false;

  Decoder(const uint8_t* d, int64_t n) : data(d), len(n) {
    // Python mirror: b"\x00" + data + 8 zero bytes; pos starts after the
    // virtual 0.  next_byte(i) with i in [0, len+8) maps to data[i] or 0.
    for (int i = 0; i < 4; i++) code = (code << 8) | next_byte();
  }
  uint8_t next_byte() {
    if (pos >= len + 8) {
      error = true;
      return 0;
    }
    uint8_t b = pos < len ? data[pos] : 0;
    pos++;
    return b;
  }
  void renorm() {
    while (range < TOP) {
      code = (code << 8) | next_byte();
      range <<= 8;
    }
  }
  int decode_bin(Contexts& c, int idx) {
    uint32_t bound = (range >> PROB_BITS) * (uint32_t)c.prob(idx);
    int bin;
    if (code < bound) {
      bin = 1;
      range = bound;
    } else {
      bin = 0;
      code -= bound;
      range -= bound;
    }
    c.update(idx, bin);
    renorm();
    return bin;
  }
  int decode_bypass() {
    range >>= 1;
    int bin;
    if (code < range) {
      bin = 1;
    } else {
      code -= range;
      bin = 0;
    }
    renorm();
    return bin;
  }
  uint32_t decode_bypass_bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | (uint32_t)decode_bypass();
    return v;
  }
};

// ---- scan tables (mirror of syntax.py diag_scan/tu_scan) ------------------
struct Scan {
  std::vector<int> x, y;   // full TU scan
  std::vector<int> cgx, cgy;
};

void diag_scan(int n, std::vector<int>& xs, std::vector<int>& ys) {
  for (int d = 0; d <= 2 * n - 2; d++) {
    int yy = d < n ? d : n - 1;
    while (yy >= 0 && d - yy < n) {
      xs.push_back(d - yy);
      ys.push_back(yy);
      yy--;
    }
  }
}

Scan make_scan(int size) {
  Scan s;
  std::vector<int> ix, iy;
  diag_scan(4, ix, iy);
  diag_scan(size / 4, s.cgx, s.cgy);
  for (size_t cg = 0; cg < s.cgx.size(); cg++)
    for (int i = 0; i < 16; i++) {
      s.x.push_back(s.cgx[cg] * 4 + ix[i]);
      s.y.push_back(s.cgy[cg] * 4 + iy[i]);
    }
  return s;
}

Scan SCANS[3 + 1];  // index by log2(size) - 2: 4, 8, 16, 32
bool scans_init = false;
void init_scans() {
  if (scans_init) return;
  SCANS[0] = make_scan(4);
  SCANS[1] = make_scan(8);
  SCANS[2] = make_scan(16);
  SCANS[3] = make_scan(32);
  scans_init = true;
}
const Scan& scan_for(int size) {
  return SCANS[(31 - __builtin_clz((unsigned)size)) - 2];
}

// ---- shared syntax helpers ------------------------------------------------
constexpr int PLANAR = 0, DC_MODE = 1;
constexpr int PRED_INTRA = 0, PRED_INTER = 1, PRED_SKIP = 2;
constexpr int PRED_L1 = 3, PRED_BI = 4;

int sig_ctx(int px, int py, int cg, bool chroma) {
  int d = px + py;
  if (d > 5) d = 5;
  if (chroma) return CTX_SIG + 12 + d;
  return CTX_SIG + d + (cg == 0 ? 0 : 6);
}

void mpm_list(int left, int above, int n_modes, int mpm[3]) {
  int vert = n_modes == 35 ? 26 : 50;
  int n_ang = n_modes - 2;
  if (left == above) {
    if (left < 2) {
      mpm[0] = PLANAR; mpm[1] = DC_MODE; mpm[2] = vert;
    } else {
      mpm[0] = left;
      mpm[1] = 2 + ((left - 2 + n_ang - 1) % n_ang);
      mpm[2] = 2 + ((left - 2 + 1) % n_ang);
    }
  } else {
    mpm[0] = left;
    mpm[1] = above;
    for (int m : {PLANAR, DC_MODE, vert})
      if (m != left && m != above) { mpm[2] = m; break; }
  }
}

struct Picture {
  int width, height, max_cu;
  int n_modes = 35;            // 35 (HEVC subset) or 67 (VVC)
  int mode_bits = 5;           // non-MPM rank bits: 5 or 6
  int ux_n, uy_n, ctus_x, ctus_y;
  int32_t* size_map;
  int32_t* mode_map;
  int32_t* coef_y;
  int32_t* coef_cb;
  int32_t* coef_cr;
  int has_mts = 0;                 // tool bits: 0 cfg.mts,
                                   // 1 cfg.transform_skip,
                                   // 2 cfg.merge_cands, 3 cfg.cclm,
                                   // 4 cfg.mtt, 5 cfg.lfnst
  int32_t* mts_map = nullptr;      // (Uy, Ux), 0..4
  int is_p = 0;                    // P or B slice
  int is_b = 0;                    // B slice (L1/bi kinds allowed)
  int32_t* pred_map = nullptr;     // (Uy, Ux) engine.inter.PRED_*
  int32_t* mvx_map = nullptr;      // (Uy, Ux) quarter-pel, primary
  int32_t* mvy_map = nullptr;
  int32_t* mvx1_map = nullptr;     // bi-prediction's L1 MV
  int32_t* mvy1_map = nullptr;
  int has_sao = 0;                 // SAO plane count: 0 off, 1 luma,
                                   // 3 luma+chroma (cfg.sao_chroma)
  int32_t* sao_type = nullptr;     // (planes, Cy, Cx)
  int32_t* sao_band = nullptr;     // (planes, Cy, Cx)
  int32_t* sao_off = nullptr;      // (planes, Cy, Cx, 4)

  // Non-intra neighbors count as DC (mirror of syntax.py rule);
  // MIP-coded neighbors (mode >= n_modes) derive MPMs as planar.
  int neighbor_left(int ux, int uy) const {
    if (ux <= 0) return DC_MODE;
    if (is_p && pred_map[uy * ux_n + ux - 1] != PRED_INTRA)
      return DC_MODE;
    int m = mode_map[uy * ux_n + ux - 1];
    return m >= n_modes ? PLANAR : m;
  }
  int neighbor_above(int ux, int uy) const {
    if (!(uy > 0 && (uy & 7) != 0)) return DC_MODE;
    if (is_p && pred_map[(uy - 1) * ux_n + ux] != PRED_INTRA)
      return DC_MODE;
    int m = mode_map[(uy - 1) * ux_n + ux];
    return m >= n_modes ? PLANAR : m;
  }
  // Predictor-eligible neighbor: coded-MV inter, NOT skip (one-hop
  // derivation; mirrors engine.inter._coded_mv).
  static bool coded_mv(int kind) {
    return kind != PRED_INTRA && kind != PRED_SKIP;
  }
  // Merge candidate 1 (C7): the above rule alone.
  void mv_above(int ux, int uy, int* px, int* py) const {
    if (uy > 0 && (uy & 7) != 0 &&
        coded_mv(pred_map[(uy - 1) * ux_n + ux])) {
      *px = mvx_map[(uy - 1) * ux_n + ux];
      *py = mvy_map[(uy - 1) * ux_n + ux];
      return;
    }
    *px = 0;
    *py = 0;
  }
  // Skip/MVD predictor; mirrors engine.inter.mv_predictor_np.
  void mv_predictor(int ux, int uy, int* px, int* py) const {
    if (ux > 0 && coded_mv(pred_map[uy * ux_n + ux - 1])) {
      *px = mvx_map[uy * ux_n + ux - 1];
      *py = mvy_map[uy * ux_n + ux - 1];
      return;
    }
    if (uy > 0 && (uy & 7) != 0 &&
        coded_mv(pred_map[(uy - 1) * ux_n + ux])) {
      *px = mvx_map[(uy - 1) * ux_n + ux];
      *py = mvy_map[(uy - 1) * ux_n + ux];
      return;
    }
    *px = 0;
    *py = 0;
  }
};

// ---- encoder walker -------------------------------------------------------
struct SegEncoder {
  Picture& pic;
  Encoder enc;
  Contexts ctxs;

  explicit SegEncoder(Picture& p) : pic(p) {}

  void code_last(int base, int v, int size) {
    int g = group_idx(v), gmax = max_group(size);
    for (int b = 0; b < g; b++)
      enc.encode_bin(ctxs, base + (b < 9 ? b : 9), 1);
    if (g < gmax) enc.encode_bin(ctxs, base + (g < 9 ? g : 9), 0);
    int nbits = group_suffix_bits(g);
    if (nbits) enc.encode_bypass_bits((uint32_t)(v - MIN_IN_GROUP[g]),
                                      nbits);
  }

  int code_remainder(int r, int k) {
    int q = r >> k;
    if (q < 4) {
      for (int i = 0; i < q; i++) enc.encode_bypass(1);
      enc.encode_bypass(0);
      if (k) enc.encode_bypass_bits((uint32_t)(r & ((1 << k) - 1)), k);
    } else {
      for (int i = 0; i < 4; i++) enc.encode_bypass(1);
      int v = r - (4 << k);
      int m = k + 1;
      while (v >= (1 << m)) {
        enc.encode_bypass(1);
        v -= 1 << m;
        m++;
      }
      enc.encode_bypass(0);
      enc.encode_bypass_bits((uint32_t)v, m);
    }
    if (r > (3 << k) && k < 4) k++;
    return k;
  }

  void residual(const int32_t* plane, int stride, int x0, int y0, int s,
                bool chroma) {
    init_scans();
    const Scan& sc = scan_for(s);
    int n = s * s;
    std::vector<int32_t> coefs(n);
    for (int i = 0; i < n; i++)
      coefs[i] = plane[(y0 + sc.y[i]) * stride + (x0 + sc.x[i])];
    int last = -1;
    for (int i = n - 1; i >= 0; i--)
      if (coefs[i]) { last = i; break; }
    // caller guarantees cbf=1 => last >= 0
    int coff = chroma ? 10 : 0;
    code_last(CTX_LAST_X + coff, sc.x[last], s);
    code_last(CTX_LAST_Y + coff, sc.y[last], s);

    int ncg = s / 4;
    int last_cg = last / 16;
    std::vector<uint8_t> csbf(ncg * ncg, 0);
    for (int cg = 0; cg <= last_cg; cg++) {
      int hi = (cg + 1) * 16 - 1 < last ? (cg + 1) * 16 - 1 : last;
      for (int i = cg * 16; i <= hi; i++)
        if (coefs[i]) { csbf[cg] = 1; break; }
    }
    csbf[0] = 1;  // inferred coded (see syntax.py)

    for (int cg = last_cg; cg >= 0; cg--) {
      int cgx = sc.cgx[cg], cgy = sc.cgy[cg];
      bool inferred = (cg == last_cg) || (cg == 0);
      if (!inferred) {
        int nb = 0;
        // right / below CG already coded in reverse scan
        for (int j = 0; j < ncg * ncg; j++) {
          if ((sc.cgx[j] == cgx + 1 && sc.cgy[j] == cgy && csbf[j]) ||
              (sc.cgx[j] == cgx && sc.cgy[j] == cgy + 1 && csbf[j])) {
            nb = 1;
            break;
          }
        }
        enc.encode_bin(ctxs, CTX_CSBF + nb + 2 * (int)chroma, csbf[cg]);
      }
      if (!csbf[cg]) continue;
      int hi = (cg + 1) * 16 - 1 < last ? (cg + 1) * 16 - 1 : last;
      int rice_k = 0;
      std::vector<int> sigs;
      for (int i = hi; i >= cg * 16; i--) {
        int level = coefs[i];
        int sig = level != 0;
        if (i != last) {
          enc.encode_bin(ctxs,
                         sig_ctx(sc.x[i] & 3, sc.y[i] & 3, cg, chroma),
                         sig);
        }
        if (sig) sigs.push_back(i);
      }
      // SDH (C11): hide the CG's first significant sign when the
      // span reaches 4 (parity enforced device-side, quant.sdh_adjust)
      bool sdh_hide = (pic.has_mts & 128) && !sigs.empty() &&
                      sigs.front() - sigs.back() >= 4;
      for (int i : sigs) {
        int level = coefs[i];
        int al = level < 0 ? -level : level;
        int g1 = al > 1;
        int ctx1 = CTX_GT1 + (chroma ? 2 : 0) + (cg == 0 ? 0 : 1);
        enc.encode_bin(ctxs, ctx1, g1);
        if (g1) {
          int g2 = al > 2;
          enc.encode_bin(ctxs, CTX_GT2 + (chroma ? 1 : 0), g2);
          if (g2) rice_k = code_remainder(al - 3, rice_k);
        }
        if (!(sdh_hide && i == sigs.back()))
          enc.encode_bypass(level < 0);
      }
    }
  }

  void code_intra_mode(int ux, int uy) {
    // Luma mode: [mip_flag + 3-bit idx (has_mip)] | MPM scheme.
    int mode = pic.mode_map[uy * pic.ux_n + ux];
    if (pic.has_mts & 64) {
      int is_mip = mode >= pic.n_modes;
      enc.encode_bin(ctxs, CTX_MIP, is_mip);
      if (is_mip) {
        enc.encode_bypass_bits((uint32_t)(mode - pic.n_modes), 3);
        return;
      }
    }
    int mpm[3];
    mpm_list(pic.neighbor_left(ux, uy), pic.neighbor_above(ux, uy),
             pic.n_modes, mpm);
    int idx = -1;
    for (int i = 0; i < 3; i++)
      if (mpm[i] == mode) { idx = i; break; }
    if (idx >= 0) {
      enc.encode_bin(ctxs, CTX_MPM_FLAG, 1);
      enc.encode_bypass(idx == 0);
      if (idx > 0) enc.encode_bypass(idx == 1);
    } else {
      enc.encode_bin(ctxs, CTX_MPM_FLAG, 0);
      int rank = mode;
      for (int i = 0; i < 3; i++)
        if (mpm[i] < mode) rank--;
      enc.encode_bypass_bits((uint32_t)rank, pic.mode_bits);
    }
  }

  void code_mvd(int v, int comp) {
    enc.encode_bin(ctxs, CTX_MVD_GT0 + comp, v != 0);
    if (v) {
      enc.encode_bypass(v < 0);
      int val = (v < 0 ? -v : v) - 1;
      int m = 1;
      while (val >= (1 << m)) {
        enc.encode_bypass(1);
        val -= 1 << m;
        m++;
      }
      enc.encode_bypass(0);
      enc.encode_bypass_bits((uint32_t)val, m);
    }
  }

  // exact bin count code_mvd would emit (AMVP candidate choice)
  static int mvd_bits(int v) {
    if (v == 0) return 1;
    int val = (v < 0 ? -v : v) - 1;
    int m = 1, bits = 2;
    while (val >= (1 << m)) {
      bits++;
      val -= 1 << m;
      m++;
    }
    return bits + 1 + m;
  }

  void leaf(int x, int y, int s) {
    int ux = x / 8, uy = y / 8;
    if (pic.is_p) {
      int kind = pic.pred_map[uy * pic.ux_n + ux];
      enc.encode_bin(ctxs, CTX_SKIP, kind == PRED_SKIP);
      if (kind == PRED_SKIP) {
        if (pic.has_mts & 4) {
          int px, py;
          pic.mv_predictor(ux, uy, &px, &py);
          int midx = (pic.mvx_map[uy * pic.ux_n + ux] != px ||
                      pic.mvy_map[uy * pic.ux_n + ux] != py);
          enc.encode_bin(ctxs, CTX_MERGE_IDX, midx);
        }
        return;
      }
      enc.encode_bin(ctxs, CTX_PRED_MODE, kind == PRED_INTRA);
      if (kind != PRED_INTRA) {
        if (pic.is_b) {
          enc.encode_bin(ctxs, CTX_BLIST, kind == PRED_BI);
          if (kind != PRED_BI)
            enc.encode_bin(ctxs, CTX_BLIST + 1, kind == PRED_L1);
        }
        int px, py;
        pic.mv_predictor(ux, uy, &px, &py);
        int mvx = pic.mvx_map[uy * pic.ux_n + ux];
        int mvy = pic.mvy_map[uy * pic.ux_n + ux];
        if (pic.has_mts & 256) {          // AMVP + merge-with-residual
          int ax, ay;
          pic.mv_above(ux, uy, &ax, &ay);
          bool same = (ax == px && ay == py);
          if (kind != PRED_BI) {
            bool merge = (mvx == px && mvy == py) ||
                         (mvx == ax && mvy == ay);
            enc.encode_bin(ctxs, CTX_AMVP_MERGE, merge);
            if (merge) {
              if (!same)
                enc.encode_bin(ctxs, CTX_MERGE_IDX,
                               !(mvx == px && mvy == py));
              leaf_residuals(x, y, s);
              return;
            }
          }
          if (!same) {
            int b0 = mvd_bits(mvx - px) + mvd_bits(mvy - py);
            int b1 = mvd_bits(mvx - ax) + mvd_bits(mvy - ay);
            int idx = b1 < b0;
            enc.encode_bin(ctxs, CTX_AMVP_IDX, idx);
            if (idx) { px = ax; py = ay; }
          }
        }
        code_mvd(mvx - px, 0);
        code_mvd(mvy - py, 1);
        if (kind == PRED_BI) {
          code_mvd(pic.mvx1_map[uy * pic.ux_n + ux] - px, 0);
          code_mvd(pic.mvy1_map[uy * pic.ux_n + ux] - py, 1);
        }
        leaf_residuals(x, y, s);
        return;
      }
    }
    code_intra_mode(ux, uy);
    if ((pic.has_mts & 8) && !pic.is_p)  // chroma CCLM flag (C6)
      enc.encode_bin(ctxs, CTX_CCLM,
                     (pic.mts_map[uy * pic.ux_n + ux] >> 3) & 1);
    leaf_residuals(x, y, s);
  }

  void leaf_residuals(int x, int y, int s) {
    int ux = x / 8, uy = y / 8;
    int w = pic.width, cw = w / 2;
    // a 64-TU codes only its low 32x32 band (DCT-II zero-out, C10
    // round-5); MTS/TS/LFNST are implicitly off at 64
    int ls = (s == 64) ? 32 : s;
    auto any_nz = [](const int32_t* p, int stride, int x0, int y0,
                     int n) {
      for (int j = 0; j < n; j++)
        for (int i = 0; i < n; i++)
          if (p[(y0 + j) * stride + x0 + i]) return 1;
      return 0;
    };
    int cbf_y = any_nz(pic.coef_y, w, x, y, ls);
    int cbf_cb = any_nz(pic.coef_cb, cw, x / 2, y / 2, s / 2);
    int cbf_cr = any_nz(pic.coef_cr, cw, x / 2, y / 2, s / 2);
    enc.encode_bin(ctxs, CTX_CBF_Y + (s >= 16 ? 0 : 1), cbf_y);
    enc.encode_bin(ctxs, CTX_CBF_C + 0, cbf_cb);
    enc.encode_bin(ctxs, CTX_CBF_C + 1, cbf_cr);
    int mts = pic.mts_map[uy * pic.ux_n + ux] & 7;  // bit 3 is CCLM
    if ((pic.has_mts & 2) && cbf_y && s < 64)
      enc.encode_bin(ctxs, CTX_TS_FLAG, mts == 5);
    if ((pic.has_mts & 1) && cbf_y && mts != 5 && s < 64) {
      enc.encode_bin(ctxs, CTX_MTS, mts > 0);
      if (mts > 0) enc.encode_bypass_bits((uint32_t)(mts - 1), 2);
    }
    if ((pic.has_mts & 32) && !pic.is_p && cbf_y && mts == 0
        && s < 64) {
      int lf = (pic.mts_map[uy * pic.ux_n + ux] >> 6) & 3;
      enc.encode_bin(ctxs, CTX_LFNST, lf > 0);
      if (lf) enc.encode_bypass(lf == 2);
    }
    if (cbf_y) residual(pic.coef_y, w, x, y, ls, false);
    if (cbf_cb) residual(pic.coef_cb, cw, x / 2, y / 2, s / 2, true);
    if (cbf_cr) residual(pic.coef_cr, cw, x / 2, y / 2, s / 2, true);
  }

  void sao_params(int cy, int cxi) {
    // luma params, then Cb and Cr iff sao_chroma (mirror of syntax.py)
    for (int p = 0; p < pic.has_sao; p++) {
      int idx = (p * pic.ctus_y + cy) * pic.ctus_x + cxi;
      int stype = pic.sao_type[idx];
      enc.encode_bin(ctxs, CTX_SAO_ON, stype != 0);
      if (stype == 0) continue;
      int is_band = stype == 5;
      enc.encode_bin(ctxs, CTX_SAO_KIND, is_band);
      if (is_band)
        enc.encode_bypass_bits((uint32_t)pic.sao_band[idx], 5);
      else
        enc.encode_bypass_bits((uint32_t)(stype - 1), 2);
      for (int i = 0; i < 4; i++) {
        int off = pic.sao_off[idx * 4 + i];
        int mag = off < 0 ? -off : off;
        for (int j = 0; j < mag; j++) enc.encode_bypass(1);
        if (mag < 7) enc.encode_bypass(0);
        if (is_band && mag) enc.encode_bypass(off < 0);
      }
    }
  }

  void node(int x, int y, int s) {
    if (x >= pic.width || y >= pic.height) return;
    if (s > pic.max_cu || x + s > pic.width || y + s > pic.height) {
      int half = s / 2;
      node(x, y, half);
      node(x + half, y, half);
      node(x, y + half, half);
      node(x + half, y + half, half);
      return;
    }
    int ux = x / 8, uy = y / 8;
    int actual = pic.size_map[uy * pic.ux_n + ux];
    if (s > 8) {
      int split = actual < s;
      enc.encode_bin(ctxs, CTX_SPLIT + (s == 32 ? 0 : 1), split);
      if (split) {
        int half = s / 2;
        node(x, y, half);
        node(x + half, y, half);
        node(x, y + half, half);
        node(x + half, y + half, half);
        return;
      }
    }
    if ((pic.has_mts & 16) && s > 8 && !pic.is_p) {   // MTT (C5)
      int bt = (pic.mts_map[uy * pic.ux_n + ux] >> 4) & 3;
      enc.encode_bin(ctxs, CTX_BT_FLAG + (s == 32 ? 0 : 1), bt != 0);
      if (bt) {
        enc.encode_bin(ctxs, CTX_BT_DIR, bt == 2);
        leaf_rect(x, y, s, bt);
        return;
      }
    }
    leaf(x, y, s);
  }

  // Two rectangular MTT CUs (mirror of syntax.py _leaf_rect): bt=1
  // BT-H (h=s/2, w=s, stacked), bt=2 BT-V (h=s, w=s/2, side by side);
  // each codes one intra mode + its two square s/2 TUs in scan order.
  void leaf_rect(int x, int y, int s, int bt) {
    int t = s / 2;
    for (int k = 0; k < 2; k++) {
      int cux = x + (bt == 2 ? t * k : 0);
      int cuy = y + (bt == 1 ? t * k : 0);
      int ux = cux / 8, uy = cuy / 8;
      code_intra_mode(ux, uy);
      for (int j = 0; j < 2; j++) {
        int tx = cux + (bt == 1 ? t * j : 0);
        int ty = cuy + (bt == 2 ? t * j : 0);
        leaf_residuals(tx, ty, t);
      }
    }
  }
};

// ---- decoder walker -------------------------------------------------------
struct SegDecoder {
  Picture& pic;
  Decoder dec;
  Contexts ctxs;

  SegDecoder(Picture& p, const uint8_t* data, int64_t len)
      : pic(p), dec(data, len) {}

  int decode_last(int base, int size) {
    int gmax = max_group(size);
    int g = 0;
    while (g < gmax && dec.decode_bin(ctxs, base + (g < 9 ? g : 9))) g++;
    int v = MIN_IN_GROUP[g];
    int nbits = group_suffix_bits(g);
    if (nbits) v += (int)dec.decode_bypass_bits(nbits);
    return v;
  }

  int decode_remainder(int& k) {
    int q = 0;
    while (q < 4 && dec.decode_bypass()) q++;
    int r;
    if (q < 4) {
      r = q << k;
      if (k) r += (int)dec.decode_bypass_bits(k);
    } else {
      int m = k + 1;
      int base = 4 << k;
      while (dec.decode_bypass()) {
        base += 1 << m;
        m++;
        if (m > 24) { dec.error = true; return 0; }
      }
      r = base + (int)dec.decode_bypass_bits(m);
    }
    if (r > (3 << k) && k < 4) k++;
    return r;
  }

  void residual(int32_t* plane, int stride, int x0, int y0, int s,
                bool chroma) {
    init_scans();
    const Scan& sc = scan_for(s);
    int n = s * s;
    int coff = chroma ? 10 : 0;
    int lx = decode_last(CTX_LAST_X + coff, s);
    int ly = decode_last(CTX_LAST_Y + coff, s);
    int last = -1;
    for (int i = 0; i < n; i++)
      if (sc.x[i] == lx && sc.y[i] == ly) { last = i; break; }
    if (last < 0) { dec.error = true; return; }

    int ncg = s / 4;
    int last_cg = last / 16;
    std::vector<uint8_t> csbf(ncg * ncg, 0);
    std::vector<int32_t> coefs(n, 0);
    for (int cg = last_cg; cg >= 0; cg--) {
      int cgx = sc.cgx[cg], cgy = sc.cgy[cg];
      if (cg == last_cg || cg == 0) {
        csbf[cg] = 1;
      } else {
        int nb = 0;
        for (int j = 0; j < ncg * ncg; j++) {
          if ((sc.cgx[j] == cgx + 1 && sc.cgy[j] == cgy && csbf[j]) ||
              (sc.cgx[j] == cgx && sc.cgy[j] == cgy + 1 && csbf[j])) {
            nb = 1;
            break;
          }
        }
        csbf[cg] = (uint8_t)dec.decode_bin(
            ctxs, CTX_CSBF + nb + 2 * (int)chroma);
      }
      if (!csbf[cg]) continue;
      int hi = (cg + 1) * 16 - 1 < last ? (cg + 1) * 16 - 1 : last;
      int rice_k = 0;
      std::vector<int> sigs;
      for (int i = hi; i >= cg * 16; i--) {
        int sig;
        if (i == last)
          sig = 1;
        else
          sig = dec.decode_bin(
              ctxs, sig_ctx(sc.x[i] & 3, sc.y[i] & 3, cg, chroma));
        if (sig) sigs.push_back(i);
      }
      bool sdh_hide = (pic.has_mts & 128) && !sigs.empty() &&
                      sigs.front() - sigs.back() >= 4;
      for (int i : sigs) {
        int ctx1 = CTX_GT1 + (chroma ? 2 : 0) + (cg == 0 ? 0 : 1);
        int al = 1;
        if (dec.decode_bin(ctxs, ctx1)) {
          al = 2;
          if (dec.decode_bin(ctxs, CTX_GT2 + (chroma ? 1 : 0)))
            al = 3 + decode_remainder(rice_k);
        }
        if (sdh_hide && i == sigs.back()) {
          // SDH: sign from the CG's abs-level-sum parity
          long long par = al;
          for (int k = cg * 16; k <= hi; k++)
            par += coefs[k] < 0 ? -coefs[k] : coefs[k];
          coefs[i] = (par & 1) ? -al : al;
        } else {
          if (dec.decode_bypass()) al = -al;
          coefs[i] = al;
        }
      }
    }
    for (int i = 0; i < n; i++)
      plane[(y0 + sc.y[i]) * stride + (x0 + sc.x[i])] = coefs[i];
  }

  int parse_intra_mode(int ux, int uy) {
    // Mirror of code_intra_mode.
    if ((pic.has_mts & 64) && dec.decode_bin(ctxs, CTX_MIP))
      return pic.n_modes + (int)dec.decode_bypass_bits(3);
    int mpm[3];
    mpm_list(pic.neighbor_left(ux, uy), pic.neighbor_above(ux, uy),
             pic.n_modes, mpm);
    int mode;
    if (dec.decode_bin(ctxs, CTX_MPM_FLAG)) {
      if (dec.decode_bypass())
        mode = mpm[0];
      else if (dec.decode_bypass())
        mode = mpm[1];
      else
        mode = mpm[2];
    } else {
      mode = (int)dec.decode_bypass_bits(pic.mode_bits);
      int sorted[3] = {mpm[0], mpm[1], mpm[2]};
      if (sorted[0] > sorted[1]) std::swap(sorted[0], sorted[1]);
      if (sorted[1] > sorted[2]) std::swap(sorted[1], sorted[2]);
      if (sorted[0] > sorted[1]) std::swap(sorted[0], sorted[1]);
      for (int i = 0; i < 3; i++)
        if (mode >= sorted[i]) mode++;
    }
    return mode;
  }

  int decode_mvd(int comp) {
    if (!dec.decode_bin(ctxs, CTX_MVD_GT0 + comp)) return 0;
    int neg = dec.decode_bypass();
    int m = 1;
    int base = 1;
    while (dec.decode_bypass()) {
      base += 1 << m;
      m++;
      if (m > 20) { dec.error = true; return 0; }
    }
    int v = base + (int)dec.decode_bypass_bits(m);
    return neg ? -v : v;
  }

  void fill_pred(int ux, int uy, int u, int kind, int mvx, int mvy) {
    for (int j = 0; j < u; j++)
      for (int i = 0; i < u; i++) {
        pic.pred_map[(uy + j) * pic.ux_n + ux + i] = kind;
        pic.mvx_map[(uy + j) * pic.ux_n + ux + i] = mvx;
        pic.mvy_map[(uy + j) * pic.ux_n + ux + i] = mvy;
      }
  }

  void leaf(int x, int y, int s) {
    int ux = x / 8, uy = y / 8;
    if (pic.is_p) {
      int u = s / 8;
      for (int j = 0; j < u; j++)
        for (int i = 0; i < u; i++)
          pic.size_map[(uy + j) * pic.ux_n + ux + i] = s;
      if (dec.decode_bin(ctxs, CTX_SKIP)) {
        int px, py;
        pic.mv_predictor(ux, uy, &px, &py);
        if ((pic.has_mts & 4) && dec.decode_bin(ctxs, CTX_MERGE_IDX))
          pic.mv_above(ux, uy, &px, &py);
        fill_pred(ux, uy, u, PRED_SKIP, px, py);
        return;
      }
      if (!dec.decode_bin(ctxs, CTX_PRED_MODE)) {
        int kind = PRED_INTER;
        if (pic.is_b) {
          if (dec.decode_bin(ctxs, CTX_BLIST))
            kind = PRED_BI;
          else if (dec.decode_bin(ctxs, CTX_BLIST + 1))
            kind = PRED_L1;
        }
        int px, py;
        pic.mv_predictor(ux, uy, &px, &py);
        if (pic.has_mts & 256) {          // AMVP + merge-with-residual
          int ax, ay;
          pic.mv_above(ux, uy, &ax, &ay);
          bool same = (ax == px && ay == py);
          if (kind != PRED_BI &&
              dec.decode_bin(ctxs, CTX_AMVP_MERGE)) {
            int mx = px, my = py;
            if (!same && dec.decode_bin(ctxs, CTX_MERGE_IDX)) {
              mx = ax;
              my = ay;
            }
            fill_pred(ux, uy, u, kind, mx, my);
            leaf_residuals(x, y, s);
            return;
          }
          if (!same && dec.decode_bin(ctxs, CTX_AMVP_IDX)) {
            px = ax;
            py = ay;
          }
        }
        int mvx = px + decode_mvd(0);
        int mvy = py + decode_mvd(1);
        fill_pred(ux, uy, u, kind, mvx, mvy);
        if (kind == PRED_BI) {
          int m1x = px + decode_mvd(0);
          int m1y = py + decode_mvd(1);
          for (int j = 0; j < u; j++)
            for (int i = 0; i < u; i++) {
              pic.mvx1_map[(uy + j) * pic.ux_n + ux + i] = m1x;
              pic.mvy1_map[(uy + j) * pic.ux_n + ux + i] = m1y;
            }
        }
        leaf_residuals(x, y, s);
        return;
      }
    }
    int mode = parse_intra_mode(ux, uy);
    int u = s / 8;
    for (int j = 0; j < u; j++)
      for (int i = 0; i < u; i++) {
        pic.size_map[(uy + j) * pic.ux_n + ux + i] = s;
        pic.mode_map[(uy + j) * pic.ux_n + ux + i] = mode;
      }
    if ((pic.has_mts & 8) && !pic.is_p) {   // chroma CCLM flag (C6)
      int cc = dec.decode_bin(ctxs, CTX_CCLM);
      for (int j = 0; j < u; j++)
        for (int i = 0; i < u; i++)
          pic.mts_map[(uy + j) * pic.ux_n + ux + i] |= cc << 3;
    }
    leaf_residuals(x, y, s);
  }

  void leaf_residuals(int x, int y, int s) {
    int ux = x / 8, uy = y / 8;
    int u = s / 8;
    int ls = (s == 64) ? 32 : s;   // 64-TU: low-band, no MTS/TS/LFNST
    int cbf_y = dec.decode_bin(ctxs, CTX_CBF_Y + (s >= 16 ? 0 : 1));
    int cbf_cb = dec.decode_bin(ctxs, CTX_CBF_C + 0);
    int cbf_cr = dec.decode_bin(ctxs, CTX_CBF_C + 1);
    int mts = 0;
    if ((pic.has_mts & 3) && cbf_y && s < 64) {
      int ts = (pic.has_mts & 2) && dec.decode_bin(ctxs, CTX_TS_FLAG);
      if (ts) {
        mts = 5;
      } else if (pic.has_mts & 1) {
        if (dec.decode_bin(ctxs, CTX_MTS))
          mts = 1 + (int)dec.decode_bypass_bits(2);
      }
      for (int j = 0; j < u; j++)
        for (int i = 0; i < u; i++)
          pic.mts_map[(uy + j) * pic.ux_n + ux + i] |= mts;
    }
    if ((pic.has_mts & 32) && !pic.is_p && cbf_y && mts == 0
        && s < 64) {
      if (dec.decode_bin(ctxs, CTX_LFNST)) {
        int lf = dec.decode_bypass() ? 2 : 1;
        for (int j = 0; j < u; j++)
          for (int i = 0; i < u; i++)
            pic.mts_map[(uy + j) * pic.ux_n + ux + i] |= lf << 6;
      }
    }
    int w = pic.width, cw = w / 2;
    if (cbf_y) residual(pic.coef_y, w, x, y, ls, false);
    if (cbf_cb) residual(pic.coef_cb, cw, x / 2, y / 2, s / 2, true);
    if (cbf_cr) residual(pic.coef_cr, cw, x / 2, y / 2, s / 2, true);
  }

  void sao_params(int cy, int cxi) {
    for (int p = 0; p < pic.has_sao; p++) {
      int idx = (p * pic.ctus_y + cy) * pic.ctus_x + cxi;
      if (!dec.decode_bin(ctxs, CTX_SAO_ON)) {
        pic.sao_type[idx] = 0;
        continue;
      }
      int is_band = dec.decode_bin(ctxs, CTX_SAO_KIND);
      if (is_band) {
        pic.sao_type[idx] = 5;
        pic.sao_band[idx] = (int32_t)dec.decode_bypass_bits(5);
      } else {
        pic.sao_type[idx] = 1 + (int32_t)dec.decode_bypass_bits(2);
      }
      for (int i = 0; i < 4; i++) {
        int mag = 0;
        while (mag < 7 && dec.decode_bypass()) mag++;
        if (is_band) {
          int neg = mag && dec.decode_bypass();
          pic.sao_off[idx * 4 + i] = neg ? -mag : mag;
        } else {
          pic.sao_off[idx * 4 + i] = i < 2 ? mag : -mag;
        }
      }
    }
  }

  void node(int x, int y, int s) {
    if (dec.error) return;
    if (x >= pic.width || y >= pic.height) return;
    if (s > pic.max_cu || x + s > pic.width || y + s > pic.height) {
      int half = s / 2;
      node(x, y, half);
      node(x + half, y, half);
      node(x, y + half, half);
      node(x + half, y + half, half);
      return;
    }
    if (s > 8) {
      if (dec.decode_bin(ctxs, CTX_SPLIT + (s == 32 ? 0 : 1))) {
        int half = s / 2;
        node(x, y, half);
        node(x + half, y, half);
        node(x, y + half, half);
        node(x + half, y + half, half);
        return;
      }
    }
    if ((pic.has_mts & 16) && s > 8 && !pic.is_p) {   // MTT (C5)
      if (dec.decode_bin(ctxs, CTX_BT_FLAG + (s == 32 ? 0 : 1))) {
        int bt = dec.decode_bin(ctxs, CTX_BT_DIR) ? 2 : 1;
        leaf_rect(x, y, s, bt);
        return;
      }
    }
    leaf(x, y, s);
  }

  void leaf_rect(int x, int y, int s, int bt) {
    int t = s / 2;
    int us = s / 8, ut = t / 8;
    int ux0 = x / 8, uy0 = y / 8;
    for (int j = 0; j < us; j++)
      for (int i = 0; i < us; i++) {
        pic.size_map[(uy0 + j) * pic.ux_n + ux0 + i] = s;
        pic.mts_map[(uy0 + j) * pic.ux_n + ux0 + i] |= bt << 4;
      }
    for (int k = 0; k < 2; k++) {
      int cux = x + (bt == 2 ? t * k : 0);
      int cuy = y + (bt == 1 ? t * k : 0);
      int ux = cux / 8, uy = cuy / 8;
      int mode = parse_intra_mode(ux, uy);
      int cu_h = bt == 1 ? ut : us;
      int cu_w = bt == 1 ? us : ut;
      for (int j = 0; j < cu_h; j++)
        for (int i = 0; i < cu_w; i++)
          pic.mode_map[(uy + j) * pic.ux_n + ux + i] = mode;
      for (int j = 0; j < 2; j++) {
        int tx = cux + (bt == 1 ? t * j : 0);
        int ty = cuy + (bt == 2 ? t * j : 0);
        leaf_residuals(tx, ty, t);
      }
    }
  }
};

}  // namespace

extern "C" {

int64_t x266t_encode_segment(int32_t width, int32_t height, int32_t max_cu,
                             int32_t n_modes,
                             const int32_t* size_map,
                             const int32_t* mode_map,
                             const int32_t* coef_y, const int32_t* coef_cb,
                             const int32_t* coef_cr, int32_t has_mts,
                             const int32_t* mts_map, int32_t is_p,
                             const int32_t* pred_map,
                             const int32_t* mvx_map,
                             const int32_t* mvy_map,
                             const int32_t* mvx1_map,
                             const int32_t* mvy1_map, int32_t has_sao,
                             const int32_t* sao_type,
                             const int32_t* sao_band,
                             const int32_t* sao_off, int32_t ctu_row0,
                             int32_t ctu_row1, uint8_t* out,
                             int64_t out_capacity,
                             const int32_t* ctx_init,
                             int32_t snap_after, int32_t* ctx_out) {
  Picture pic;
  pic.width = width;
  pic.height = height;
  pic.max_cu = max_cu;
  pic.n_modes = n_modes;
  pic.mode_bits = n_modes == 35 ? 5 : 6;
  pic.ux_n = width / 8;
  pic.uy_n = height / 8;
  pic.ctus_x = (width + 63) / 64;
  pic.ctus_y = (height + 63) / 64;
  pic.size_map = const_cast<int32_t*>(size_map);
  pic.mode_map = const_cast<int32_t*>(mode_map);
  pic.coef_y = const_cast<int32_t*>(coef_y);
  pic.coef_cb = const_cast<int32_t*>(coef_cb);
  pic.coef_cr = const_cast<int32_t*>(coef_cr);
  pic.has_mts = has_mts;
  pic.mts_map = const_cast<int32_t*>(mts_map);
  pic.is_p = is_p != 0;
  pic.is_b = is_p == 2;
  pic.pred_map = const_cast<int32_t*>(pred_map);
  pic.mvx_map = const_cast<int32_t*>(mvx_map);
  pic.mvy_map = const_cast<int32_t*>(mvy_map);
  pic.mvx1_map = const_cast<int32_t*>(mvx1_map);
  pic.mvy1_map = const_cast<int32_t*>(mvy1_map);
  pic.has_sao = has_sao;
  pic.sao_type = const_cast<int32_t*>(sao_type);
  pic.sao_band = const_cast<int32_t*>(sao_band);
  pic.sao_off = const_cast<int32_t*>(sao_off);

  SegEncoder se(pic);
  if (ctx_init) se.ctxs.load(ctx_init);
  int coded = 0;
  for (int cy = ctu_row0; cy < ctu_row1; cy++)
    for (int cx = 0; cx < pic.ctus_x; cx++) {
      if (pic.has_sao) se.sao_params(cy, cx);
      se.node(cx * 64, cy * 64, 64);
      // WPP inheritance (P6): snapshot the adaptive states after the
      // segment's first snap_after CTUs (the next segment inits here)
      if (ctx_out && ++coded == snap_after) se.ctxs.store(ctx_out);
    }
  se.enc.finish();
  // drop the leading zero byte (mirror of engine.py finish())
  if (se.enc.out.empty() || se.enc.out[0] != 0) return -2;
  int64_t n = (int64_t)se.enc.out.size() - 1;
  if (n > out_capacity) return -1;
  std::memcpy(out, se.enc.out.data() + 1, (size_t)n);
  return n;
}

int64_t x266t_decode_segment(int32_t width, int32_t height, int32_t max_cu,
                             int32_t n_modes,
                             int32_t* size_map, int32_t* mode_map,
                             int32_t* coef_y, int32_t* coef_cb,
                             int32_t* coef_cr, int32_t has_mts,
                             int32_t* mts_map, int32_t is_p,
                             int32_t* pred_map, int32_t* mvx_map,
                             int32_t* mvy_map, int32_t* mvx1_map,
                             int32_t* mvy1_map, int32_t has_sao,
                             int32_t* sao_type, int32_t* sao_band,
                             int32_t* sao_off, int32_t ctu_row0,
                             int32_t ctu_row1, const uint8_t* data,
                             int64_t len, const int32_t* ctx_init,
                             int32_t snap_after, int32_t* ctx_out) {
  Picture pic;
  pic.width = width;
  pic.height = height;
  pic.max_cu = max_cu;
  pic.n_modes = n_modes;
  pic.mode_bits = n_modes == 35 ? 5 : 6;
  pic.ux_n = width / 8;
  pic.uy_n = height / 8;
  pic.ctus_x = (width + 63) / 64;
  pic.ctus_y = (height + 63) / 64;
  pic.size_map = size_map;
  pic.mode_map = mode_map;
  pic.coef_y = coef_y;
  pic.coef_cb = coef_cb;
  pic.coef_cr = coef_cr;
  pic.has_mts = has_mts;
  pic.mts_map = mts_map;
  pic.is_p = is_p != 0;
  pic.is_b = is_p == 2;
  pic.pred_map = pred_map;
  pic.mvx_map = mvx_map;
  pic.mvy_map = mvy_map;
  pic.mvx1_map = mvx1_map;
  pic.mvy1_map = mvy1_map;
  pic.has_sao = has_sao;
  pic.sao_type = sao_type;
  pic.sao_band = sao_band;
  pic.sao_off = sao_off;

  SegDecoder sd(pic, data, len);
  if (ctx_init) sd.ctxs.load(ctx_init);
  int coded = 0;
  for (int cy = ctu_row0; cy < ctu_row1; cy++)
    for (int cx = 0; cx < pic.ctus_x; cx++) {
      if (pic.has_sao) sd.sao_params(cy, cx);
      sd.node(cx * 64, cy * 64, 64);
      if (ctx_out && ++coded == snap_after) sd.ctxs.store(ctx_out);
    }
  return sd.dec.error ? -1 : 0;
}

// ---- wire-format helper (engine/fused.py download path) -------------------
// Expands the packed 4-bit coefficient plane into sign-extended int32:
// out[2i] = sext4(nib[i] & 0xF), out[2i+1] = sext4(nib[i] >> 4).  The
// numpy LUT-gather version of this costs ~100+ ms per 1080p frame on a
// small host; this loop is memory-bound (~10 ms).
void x266t_expand_nib(const uint8_t* nib, int32_t* out, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    uint8_t b = nib[i];
    out[2 * i] = ((int32_t)(b & 0xF) ^ 8) - 8;
    out[2 * i + 1] = ((int32_t)(b >> 4) ^ 8) - 8;
  }
}

}  // extern "C"
