/* Native CABAC arithmetic decoder engine.
 *
 * Exact counterpart of vtm_jax/decoder/cabac.py CabacDecoder (itself the
 * behavioral equivalent of DecoderLib/BinDecoder.cpp decodeBin:276,
 * decodeBinEP, decodeBinsEP, decodeBinTrm and the BinProbModel_Std dual
 * 15-bit probability counters, Contexts.h:87-153).  The context state
 * lives in the Python ContextModels' numpy arrays (int32), accessed here
 * through the buffer protocol, so Python-side copy()/init()/WPP snapshots
 * keep working unchanged.
 *
 * Built on demand by vtm_jax/native/__init__.py; the Python engine is the
 * always-available fallback (and the tracing engine).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>
#include <stdint.h>

#define MASK_0 (((1 << 10) - 1) << 5)  /* 0x7FE0: 10-bit counter mask */
#define MASK_1 (((1 << 14) - 1) << 1)  /* 0x7FFE: 14-bit counter mask */

typedef struct {
    PyObject_HEAD
    PyObject *data_obj;      /* bytes keeping the buffer alive */
    const uint8_t *data;
    Py_ssize_t len;
    Py_ssize_t pos;
    uint32_t range_;
    uint32_t value;
    int bits_needed;
    PyObject *ctx_obj;       /* ContextModels */
    Py_buffer b_s0, b_s1, b_r0, b_r1;
    int bufs_held;
    int32_t *s0, *s1, *r0, *r1;
    PyObject *renorm_obj;
    Py_buffer b_renorm;
    int renorm_held;
    const int32_t *renorm;
    PyObject *trace;      /* unused by the native engine (tracing uses the
                             Python engine); kept for interface parity */
    long trace_count;
} NativeCabac;

static void release_ctx_bufs(NativeCabac *self)
{
    if (self->bufs_held) {
        PyBuffer_Release(&self->b_s0);
        PyBuffer_Release(&self->b_s1);
        PyBuffer_Release(&self->b_r0);
        PyBuffer_Release(&self->b_r1);
        self->bufs_held = 0;
    }
    Py_CLEAR(self->ctx_obj);
}

static int bind_ctx(NativeCabac *self, PyObject *ctx)
{
    PyObject *a;
    release_ctx_bufs(self);
    a = PyObject_GetAttrString(ctx, "state0");
    if (!a || PyObject_GetBuffer(a, &self->b_s0, PyBUF_WRITABLE) < 0) { Py_XDECREF(a); return -1; }
    Py_DECREF(a);
    a = PyObject_GetAttrString(ctx, "state1");
    if (!a || PyObject_GetBuffer(a, &self->b_s1, PyBUF_WRITABLE) < 0) { Py_XDECREF(a); PyBuffer_Release(&self->b_s0); return -1; }
    Py_DECREF(a);
    a = PyObject_GetAttrString(ctx, "rate0");
    if (!a || PyObject_GetBuffer(a, &self->b_r0, PyBUF_SIMPLE) < 0) { Py_XDECREF(a); PyBuffer_Release(&self->b_s0); PyBuffer_Release(&self->b_s1); return -1; }
    Py_DECREF(a);
    a = PyObject_GetAttrString(ctx, "rate1");
    if (!a || PyObject_GetBuffer(a, &self->b_r1, PyBUF_SIMPLE) < 0) { Py_XDECREF(a); PyBuffer_Release(&self->b_s0); PyBuffer_Release(&self->b_s1); PyBuffer_Release(&self->b_r0); return -1; }
    Py_DECREF(a);
    self->s0 = (int32_t *)self->b_s0.buf;
    self->s1 = (int32_t *)self->b_s1.buf;
    self->r0 = (int32_t *)self->b_r0.buf;
    self->r1 = (int32_t *)self->b_r1.buf;
    self->bufs_held = 1;
    Py_INCREF(ctx);
    self->ctx_obj = ctx;
    return 0;
}

static int nc_init(NativeCabac *self, PyObject *args, PyObject *kwds)
{
    PyObject *data, *ctx, *renorm;
    if (!PyArg_ParseTuple(args, "OOO", &data, &ctx, &renorm))
        return -1;
    Py_buffer db;
    if (PyObject_GetBuffer(data, &db, PyBUF_SIMPLE) < 0)
        return -1;
    self->data = (const uint8_t *)db.buf;
    self->len = db.len;
    Py_INCREF(data);
    self->data_obj = data;
    PyBuffer_Release(&db);  /* bytes are immutable; keep the object ref */
    self->pos = 0;
    self->range_ = 0;
    self->value = 0;
    self->bits_needed = 0;
    if (PyObject_GetBuffer(renorm, &self->b_renorm, PyBUF_SIMPLE) < 0)
        return -1;
    self->renorm = (const int32_t *)self->b_renorm.buf;
    self->renorm_held = 1;
    Py_INCREF(renorm);
    self->renorm_obj = renorm;
    if (bind_ctx(self, ctx) < 0)
        return -1;
    Py_INCREF(Py_None);
    self->trace = Py_None;
    self->trace_count = 0;
    return 0;
}

static void nc_dealloc(NativeCabac *self)
{
    release_ctx_bufs(self);
    if (self->renorm_held)
        PyBuffer_Release(&self->b_renorm);
    Py_CLEAR(self->renorm_obj);
    Py_CLEAR(self->data_obj);
    Py_CLEAR(self->trace);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static inline uint32_t read_byte(NativeCabac *self)
{
    if (self->pos < self->len)
        return self->data[self->pos++];
    self->pos++;
    return 0;
}

static PyObject *nc_start(NativeCabac *self, PyObject *noargs)
{
    self->range_ = 510;
    self->value = (read_byte(self) << 8) + read_byte(self);
    self->bits_needed = -8;
    Py_RETURN_NONE;
}

static inline int decode_bin_impl(NativeCabac *self, Py_ssize_t i)
{
    int32_t s0 = self->s0[i], s1 = self->s1[i];
    uint32_t q = (uint32_t)(s0 + s1) >> 8;
    int bin_val = q >> 7;
    uint32_t qq = (q & 0x80) ? (q ^ 0xFF) : q;
    uint32_t lps = (((qq >> 2) * (self->range_ >> 5)) >> 1) + 4;
    self->range_ -= lps;
    uint32_t sr = self->range_ << 7;
    if (self->value < sr) {
        if (self->range_ < 256) {
            self->range_ <<= 1;
            self->value <<= 1;
            if (++self->bits_needed >= 0) {
                self->value += read_byte(self);
                self->bits_needed = -8;
            }
        }
    } else {
        bin_val = 1 - bin_val;
        int num_bits = self->renorm[lps >> 3];
        self->value = (self->value - sr) << num_bits;
        self->range_ = lps << num_bits;
        self->bits_needed += num_bits;
        if (self->bits_needed >= 0) {
            self->value += read_byte(self) << self->bits_needed;
            self->bits_needed -= 8;
        }
    }
    int32_t r0 = self->r0[i], r1 = self->r1[i];
    s0 -= (s0 >> r0) & MASK_0;
    s1 -= (s1 >> r1) & MASK_1;
    if (bin_val) {
        s0 += (0x7FFF >> r0) & MASK_0;
        s1 += (0x7FFF >> r1) & MASK_1;
    }
    self->s0[i] = s0;
    self->s1[i] = s1;
    return bin_val;
}

static PyObject *nc_decode_bin(NativeCabac *self, PyObject *arg)
{
    Py_ssize_t i = PyLong_AsSsize_t(arg);
    if (i == -1 && PyErr_Occurred())
        return NULL;
    return PyLong_FromLong(decode_bin_impl(self, i));
}

static inline int decode_bin_ep_impl(NativeCabac *self)
{
    self->value += self->value;
    if (++self->bits_needed >= 0) {
        self->value += read_byte(self);
        self->bits_needed = -8;
    }
    uint32_t sr = self->range_ << 7;
    if (self->value >= sr) {
        self->value -= sr;
        return 1;
    }
    return 0;
}

static PyObject *nc_decode_bin_ep(NativeCabac *self, PyObject *noargs)
{
    return PyLong_FromLong(decode_bin_ep_impl(self));
}

static uint64_t decode_aligned_bins_ep_impl(NativeCabac *self, int num_bins)
{
    int rem = num_bins;
    uint64_t bins = 0;
    while (rem > 0) {
        int n = rem < 8 ? rem : 8;
        uint32_t mask = (1u << n) - 1;
        uint32_t nb = (self->value >> (15 - n)) & mask;
        bins = (bins << n) | nb;
        self->value = (self->value << n) & 0x7FFF;
        rem -= n;
        self->bits_needed += n;
        if (self->bits_needed >= 0) {
            self->value |= read_byte(self) << self->bits_needed;
            self->bits_needed -= 8;
        }
    }
    return bins;
}

static uint64_t decode_bins_ep_impl(NativeCabac *self, int num_bins)
{
    if (num_bins == 0)
        return 0;
    if (self->range_ == 256)
        return decode_aligned_bins_ep_impl(self, num_bins);
    int rem = num_bins;
    uint64_t bins = 0;
    while (rem > 8) {
        self->value = (self->value << 8) + (read_byte(self) << (8 + self->bits_needed));
        uint32_t sr = self->range_ << 15;
        for (int k = 0; k < 8; k++) {
            bins += bins;
            sr >>= 1;
            if (self->value >= sr) {
                bins += 1;
                self->value -= sr;
            }
        }
        rem -= 8;
    }
    self->bits_needed += rem;
    self->value <<= rem;
    if (self->bits_needed >= 0) {
        self->value += read_byte(self) << self->bits_needed;
        self->bits_needed -= 8;
    }
    uint32_t sr = self->range_ << (rem + 7);
    for (int k = 0; k < rem; k++) {
        bins += bins;
        sr >>= 1;
        if (self->value >= sr) {
            bins += 1;
            self->value -= sr;
        }
    }
    return bins;
}

static PyObject *nc_decode_bins_ep(NativeCabac *self, PyObject *arg)
{
    long n = PyLong_AsLong(arg);
    if (n == -1 && PyErr_Occurred())
        return NULL;
    return PyLong_FromUnsignedLongLong(decode_bins_ep_impl(self, (int)n));
}

static PyObject *nc_decode_rem_abs_ep(NativeCabac *self, PyObject *args)
{
    long go_rice_par, cutoff, max_log2_tr_dr;
    if (!PyArg_ParseTuple(args, "lll", &go_rice_par, &cutoff, &max_log2_tr_dr))
        return NULL;
    long prefix = 0;
    long max_prefix = 32 - max_log2_tr_dr;
    int code_word = 0;
    for (;;) {
        prefix += 1;
        code_word = decode_bin_ep_impl(self);
        if (!(code_word && prefix < max_prefix))
            break;
    }
    prefix -= 1 - code_word;
    long length = go_rice_par;
    uint64_t offset;
    if (prefix < cutoff) {
        offset = (uint64_t)prefix << go_rice_par;
    } else {
        offset = (uint64_t)((1ull << (prefix - cutoff)) + cutoff - 1) << go_rice_par;
        length += (prefix == 32 - max_log2_tr_dr) ? (max_log2_tr_dr - go_rice_par)
                                                  : (prefix - cutoff);
    }
    return PyLong_FromUnsignedLongLong(offset + decode_bins_ep_impl(self, (int)length));
}

static PyObject *nc_decode_bin_trm(NativeCabac *self, PyObject *noargs)
{
    self->range_ -= 2;
    uint32_t sr = self->range_ << 7;
    if (self->value >= sr)
        return PyLong_FromLong(1);
    if (self->range_ < 256) {
        self->range_ += self->range_;
        self->value += self->value;
        if (++self->bits_needed == 0) {
            self->value += read_byte(self);
            self->bits_needed = -8;
        }
    }
    return PyLong_FromLong(0);
}

static PyObject *nc_align(NativeCabac *self, PyObject *noargs)
{
    self->range_ = 256;
    Py_RETURN_NONE;
}

/* ------------------------------------------------------------------ */
/* Residual coding at syntax level (CABACReader.cpp residual_coding:   */
/* 2878, last_sig_coeff:3110, residual_coding_subblock:3190,           */
/* residual_codingTS:3358) — the decode-side bin hot loop runs          */
/* entirely in C, one call per TU component.  Context-id derivations   */
/* mirror vtm_jax/decoder/cabac_reader.py CoeffCtx exactly.            */
/* ------------------------------------------------------------------ */

#define COEF_REMAIN_BIN_REDUCTION 5
#define SBH_THRESHOLD 4

static int32_t g_group_idx[64];
static int32_t g_min_in_group[14];
static int32_t g_go_rice[32];
static int g_tables_set = 0;

static int64_t g_frac_lut[512];  /* (256, 2) m_binFracBits */

static PyObject *mod_set_frac_table(PyObject *mod, PyObject *arg)
{
    Py_buffer b;
    if (PyObject_GetBuffer(arg, &b, PyBUF_SIMPLE) < 0) return NULL;
    memcpy(g_frac_lut, b.buf, b.len < (Py_ssize_t)sizeof(g_frac_lut) ? b.len : (Py_ssize_t)sizeof(g_frac_lut));
    PyBuffer_Release(&b);
    Py_RETURN_NONE;
}

static PyObject *mod_set_tables(PyObject *mod, PyObject *args)
{
    PyObject *gi, *mig, *gr;
    if (!PyArg_ParseTuple(args, "OOO", &gi, &mig, &gr))
        return NULL;
    Py_buffer b;
    if (PyObject_GetBuffer(gi, &b, PyBUF_SIMPLE) < 0) return NULL;
    memcpy(g_group_idx, b.buf, b.len < (Py_ssize_t)sizeof(g_group_idx) ? b.len : (Py_ssize_t)sizeof(g_group_idx));
    PyBuffer_Release(&b);
    if (PyObject_GetBuffer(mig, &b, PyBUF_SIMPLE) < 0) return NULL;
    memcpy(g_min_in_group, b.buf, b.len < (Py_ssize_t)sizeof(g_min_in_group) ? b.len : (Py_ssize_t)sizeof(g_min_in_group));
    PyBuffer_Release(&b);
    if (PyObject_GetBuffer(gr, &b, PyBUF_SIMPLE) < 0) return NULL;
    memcpy(g_go_rice, b.buf, b.len < (Py_ssize_t)sizeof(g_go_rice) ? b.len : (Py_ssize_t)sizeof(g_go_rice));
    PyBuffer_Release(&b);
    g_tables_set = 1;
    Py_RETURN_NONE;
}

static uint64_t decode_rem_abs_ep_impl(NativeCabac *self, int go_rice_par,
                                       int cutoff, int max_log2_tr_dr)
{
    long prefix = 0;
    long max_prefix = 32 - max_log2_tr_dr;
    int code_word = 0;
    for (;;) {
        prefix += 1;
        code_word = decode_bin_ep_impl(self);
        if (!(code_word && prefix < max_prefix))
            break;
    }
    prefix -= 1 - code_word;
    long length = go_rice_par;
    uint64_t offset;
    if (prefix < cutoff) {
        offset = (uint64_t)prefix << go_rice_par;
    } else {
        offset = (uint64_t)((1ull << (prefix - cutoff)) + cutoff - 1) << go_rice_par;
        length += (prefix == 32 - max_log2_tr_dr) ? (max_log2_tr_dr - go_rice_par)
                                                  : (prefix - cutoff);
    }
    return offset + decode_bins_ep_impl(self, (int)length);
}

/* shared per-component residual decoding state */
typedef struct {
    int w, h;
    int log2_cg_w, log2_cg_h, log2_cg_size;
    int wig, hig;           /* groups across/down (zero-out clipped) */
    int ch;                 /* 0 luma, 1 chroma */
    const int32_t *scan;    /* (N,3) idx,x,y */
    const int32_t *scan_cg; /* (M,3) */
    int32_t *coeff;
    uint8_t sig_group_flags[256];
    /* ctx bases */
    int ctx_last_x, ctx_last_y;
    int last_off_x, last_off_y, last_shift_x, last_shift_y;
    int sig_set[3], par_set, gtx_set[2], sig_cg_set;
    int tmpl_diag, tmpl_sum1;
    int scan_pos_last;
    /* per-subblock */
    int sub_set_id, sub_set_pos, cg_pos_x, cg_pos_y, min_sub_pos, max_sub_pos;
} RcCtx;

static inline int rc_sig_ctx_id_abs(RcCtx *rc, NativeCabac *nc, int scan_pos, int state)
{
    int x = rc->scan[scan_pos * 3 + 1];
    int y = rc->scan[scan_pos * 3 + 2];
    int base = x + y * rc->w;
    int diag = x + y;
    int num_pos = 0, sum_abs = 0;
    const int32_t *c = rc->coeff;
    int w = rc->w, h = rc->h;
#define RC_UPD(v) do { int32_t a_ = (v); a_ = a_ < 0 ? -a_ : a_; \
        sum_abs += (4 + (a_ & 1)) < a_ ? (4 + (a_ & 1)) : a_; \
        num_pos += a_ ? 1 : 0; } while (0)
    if (x < w - 1) {
        RC_UPD(c[base + 1]);
        if (x < w - 2) RC_UPD(c[base + 2]);
        if (y < h - 1) RC_UPD(c[base + w + 1]);
    }
    if (y < h - 1) {
        RC_UPD(c[base + w]);
        if (y < h - 2) RC_UPD(c[base + 2 * w]);
    }
#undef RC_UPD
    int ctx_ofs = ((sum_abs + 1) >> 1);
    if (ctx_ofs > 3) ctx_ofs = 3;
    ctx_ofs += (diag < 2) ? 4 : 0;
    if (rc->ch == 0)
        ctx_ofs += (diag < 5) ? 4 : 0;
    rc->tmpl_diag = diag;
    rc->tmpl_sum1 = sum_abs - num_pos;
    int st = state - 1;
    if (st < 0) st = 0;
    return rc->sig_set[st] + ctx_ofs;
}

static inline int rc_ctx_offset_abs(RcCtx *rc)
{
    int offset = 0;
    if (rc->tmpl_diag != -1) {
        offset = (rc->tmpl_sum1 < 4 ? rc->tmpl_sum1 : 4) + 1;
        if (rc->tmpl_diag == 0)
            offset += (rc->ch == 0) ? 15 : 5;
        else if (rc->ch == 0) {
            if (rc->tmpl_diag < 3) offset += 10;
            else if (rc->tmpl_diag < 10) offset += 5;
        }
    }
    return offset;
}

static inline int rc_template_abs_sum(RcCtx *rc, int scan_pos, int base_level)
{
    int x = rc->scan[scan_pos * 3 + 1];
    int y = rc->scan[scan_pos * 3 + 2];
    int base = x + y * rc->w;
    int w = rc->w, h = rc->h;
    const int32_t *c = rc->coeff;
    int s = 0;
#define RC_ABS(v) ((v) < 0 ? -(v) : (v))
    if (x < w - 1) {
        s += RC_ABS(c[base + 1]);
        if (x < w - 2) s += RC_ABS(c[base + 2]);
        if (y < h - 1) s += RC_ABS(c[base + w + 1]);
    }
    if (y < h - 1) {
        s += RC_ABS(c[base + w]);
        if (y < h - 2) s += RC_ABS(c[base + 2 * w]);
    }
#undef RC_ABS
    s -= 5 * base_level;
    if (s > 31) s = 31;
    if (s < 0) s = 0;
    return s;
}

static inline void rc_init_subblock(RcCtx *rc, int subset_id, int ts)
{
    rc->sub_set_id = subset_id;
    rc->sub_set_pos = rc->scan_cg[subset_id * 3];
    rc->cg_pos_y = rc->sub_set_pos / rc->wig;
    rc->cg_pos_x = rc->sub_set_pos - rc->cg_pos_y * rc->wig;
    rc->min_sub_pos = subset_id << rc->log2_cg_size;
    rc->max_sub_pos = rc->min_sub_pos + (1 << rc->log2_cg_size) - 1;
    (void)ts;
}

/* regular (non-TS) residual coding.  Returns (last_scan_pos, violates_mts) */
static PyObject *nc_rc_block(NativeCabac *self, PyObject *args)
{
    PyObject *coeff_o, *scan_o, *scan_cg_o;
    int w, h, log2_cg_w, log2_cg_h, ch;
    int sign_hiding, state_trans, reg_bin_limit, sbt_active;
    int max_last_x, max_last_y, last_off_x, last_off_y, last_shift_x, last_shift_y;
    int ctx_last_x, ctx_last_y, sig0, sig1, sig2, par_set, gtx0, gtx1, sig_cg;
    if (!PyArg_ParseTuple(args, "OOOiiiiiiiiiiiiiiiiiiiiiiii",
                          &coeff_o, &scan_o, &scan_cg_o,
                          &w, &h, &log2_cg_w, &log2_cg_h, &ch,
                          &sign_hiding, &state_trans, &reg_bin_limit, &sbt_active,
                          &max_last_x, &max_last_y, &last_off_x, &last_off_y,
                          &last_shift_x, &last_shift_y,
                          &ctx_last_x, &ctx_last_y, &sig0, &sig1, &sig2,
                          &par_set, &gtx0, &gtx1, &sig_cg))
        return NULL;
    Py_buffer cb, sb, scgb;
    if (PyObject_GetBuffer(coeff_o, &cb, PyBUF_WRITABLE) < 0) return NULL;
    if (PyObject_GetBuffer(scan_o, &sb, PyBUF_SIMPLE) < 0) { PyBuffer_Release(&cb); return NULL; }
    if (PyObject_GetBuffer(scan_cg_o, &scgb, PyBUF_SIMPLE) < 0) { PyBuffer_Release(&cb); PyBuffer_Release(&sb); return NULL; }

    RcCtx rc;
    memset(rc.sig_group_flags, 0, sizeof(rc.sig_group_flags));
    rc.w = w; rc.h = h;
    rc.log2_cg_w = log2_cg_w; rc.log2_cg_h = log2_cg_h;
    rc.log2_cg_size = log2_cg_w + log2_cg_h;
    rc.wig = ((w < 32 ? w : 32) >> log2_cg_w);
    rc.hig = ((h < 32 ? h : 32) >> log2_cg_h);
    rc.ch = ch;
    rc.scan = (const int32_t *)sb.buf;
    rc.scan_cg = (const int32_t *)scgb.buf;
    rc.coeff = (int32_t *)cb.buf;
    rc.ctx_last_x = ctx_last_x; rc.ctx_last_y = ctx_last_y;
    rc.last_off_x = last_off_x; rc.last_off_y = last_off_y;
    rc.last_shift_x = last_shift_x; rc.last_shift_y = last_shift_y;
    rc.sig_set[0] = sig0; rc.sig_set[1] = sig1; rc.sig_set[2] = sig2;
    rc.par_set = par_set; rc.gtx_set[0] = gtx0; rc.gtx_set[1] = gtx1;
    rc.sig_cg_set = sig_cg;
    rc.tmpl_diag = -1; rc.tmpl_sum1 = -1;

    /* ---- last_sig_coeff ---- */
    int pos_x = 0, pos_y = 0;
    while (pos_x < max_last_x &&
           decode_bin_impl(self, ctx_last_x + last_off_x + (pos_x >> last_shift_x)))
        pos_x++;
    while (pos_y < max_last_y &&
           decode_bin_impl(self, ctx_last_y + last_off_y + (pos_y >> last_shift_y)))
        pos_y++;
    if (pos_x > 3) {
        int n = (pos_x - 2) >> 1;
        int tmp = 0;
        for (int i = n - 1; i >= 0; i--)
            tmp += decode_bin_ep_impl(self) << i;
        pos_x = g_min_in_group[pos_x] + tmp;
    }
    if (pos_y > 3) {
        int n = (pos_y - 2) >> 1;
        int tmp = 0;
        for (int i = n - 1; i >= 0; i--)
            tmp += decode_bin_ep_impl(self) << i;
        pos_y = g_min_in_group[pos_y] + tmp;
    }
    int blk_pos_last = pos_x + pos_y * w;
    int last = -1;
    {
        Py_ssize_t n_scan = sb.len / (3 * (Py_ssize_t)sizeof(int32_t));
        for (Py_ssize_t i = 0; i < n_scan; i++)
            if (rc.scan[i * 3] == blk_pos_last) { last = (int)i; break; }
    }
    rc.scan_pos_last = last;

    int state = 0;
    int violates_mts = 0;
    int32_t *coeff = rc.coeff;

    for (int subset = last >> rc.log2_cg_size; subset >= 0; subset--) {
        rc_init_subblock(&rc, subset, 0);
        if (sbt_active) {
            if ((h == 32 && rc.cg_pos_y >= (16 >> rc.log2_cg_h)) ||
                (w == 32 && rc.cg_pos_x >= (16 >> rc.log2_cg_w)))
                continue;
        }
        /* ---- residual_coding_subblock ---- */
        int min_sub_pos = rc.min_sub_pos;
        int is_last = (rc.scan_pos_last >> rc.log2_cg_size) == rc.sub_set_id;
        int first_sig_pos = is_last ? rc.scan_pos_last : rc.max_sub_pos;
        int sig_group = is_last || rc.sub_set_id == 0;
        if (!sig_group) {
            int sig_right = (rc.cg_pos_x + 1 < rc.wig) ? rc.sig_group_flags[rc.sub_set_pos + 1] : 0;
            int sig_lower = (rc.cg_pos_y + 1 < rc.hig) ? rc.sig_group_flags[rc.sub_set_pos + rc.wig] : 0;
            sig_group = decode_bin_impl(self, rc.sig_cg_set + ((sig_right || sig_lower) ? 1 : 0));
        }
        if (sig_group)
            rc.sig_group_flags[rc.sub_set_pos] = 1;
        else
            continue;
        if (ch == 0 && (rc.cg_pos_y > 3 || rc.cg_pos_x > 3))
            violates_mts = 1;
        int next_sig_pos = first_sig_pos;
        int infer_sig_pos = (next_sig_pos != rc.scan_pos_last)
                                ? (rc.sub_set_id != 0 ? min_sub_pos : -1)
                                : next_sig_pos;
        int first_nz = next_sig_pos, last_nz = -1, num_nonzero = 0;
        int rem_reg_bins = reg_bin_limit;
        int sig_blk_pos[16];
        int pos = next_sig_pos;
        while (pos >= min_sub_pos && rem_reg_bins >= 4) {
            int blk_pos = rc.scan[pos * 3];
            int sig = (num_nonzero == 0 && pos == infer_sig_pos);
            if (!sig) {
                int sig_ctx = rc_sig_ctx_id_abs(&rc, self, pos, state);
                sig = decode_bin_impl(self, sig_ctx);
                rem_reg_bins -= 1;
            } else if (pos != rc.scan_pos_last) {
                rc_sig_ctx_id_abs(&rc, self, pos, state);
            }
            if (sig) {
                int off = rc_ctx_offset_abs(&rc);
                sig_blk_pos[num_nonzero] = blk_pos;
                num_nonzero += 1;
                first_nz = pos;
                if (pos > last_nz) last_nz = pos;
                int gt1 = decode_bin_impl(self, rc.gtx_set[1] + off);
                rem_reg_bins -= 1;
                int par = 0, gt2 = 0;
                if (gt1) {
                    par = decode_bin_impl(self, rc.par_set + off);
                    rem_reg_bins -= 1;
                    gt2 = decode_bin_impl(self, rc.gtx_set[0] + off);
                    rem_reg_bins -= 1;
                }
                coeff[blk_pos] += 1 + par + gt1 + (gt2 << 1);
            }
            state = (state_trans >> ((state << 2) + ((coeff[blk_pos] & 1) << 1))) & 3;
            pos -= 1;
        }
        int first_pos_mode2 = pos;
        reg_bin_limit = rem_reg_bins;
        /* 2nd pass: go-rice remainders for >=4 */
        for (int scan_pos = first_sig_pos; scan_pos > first_pos_mode2; scan_pos--) {
            int sum_all = rc_template_abs_sum(&rc, scan_pos, 4);
            int rice = g_go_rice[sum_all];
            int blk_pos = rc.scan[scan_pos * 3];
            if (coeff[blk_pos] >= 4) {
                uint64_t rem = decode_rem_abs_ep_impl(self, rice, COEF_REMAIN_BIN_REDUCTION, 15);
                coeff[blk_pos] += (int32_t)(rem << 1);
            }
        }
        /* bypass pass */
        for (int scan_pos = first_pos_mode2; scan_pos >= min_sub_pos; scan_pos--) {
            int sum_all = rc_template_abs_sum(&rc, scan_pos, 0);
            int rice = g_go_rice[sum_all];
            int64_t pos0 = (int64_t)(state < 2 ? 1 : 2) << rice;
            int64_t rem = (int64_t)decode_rem_abs_ep_impl(self, rice, COEF_REMAIN_BIN_REDUCTION, 15);
            int64_t tcoeff = (rem == pos0) ? 0 : (rem < pos0 ? rem + 1 : rem);
            state = (state_trans >> ((state << 2) + (((int)tcoeff & 1) << 1))) & 3;
            if (tcoeff) {
                int blk_pos = rc.scan[scan_pos * 3];
                sig_blk_pos[num_nonzero] = blk_pos;
                num_nonzero += 1;
                first_nz = scan_pos;
                if (scan_pos > last_nz) last_nz = scan_pos;
                coeff[blk_pos] = (int32_t)tcoeff;
            }
        }
        /* signs */
        int hide = sign_hiding && (last_nz - first_nz >= SBH_THRESHOLD);
        int num_signs = hide ? num_nonzero - 1 : num_nonzero;
        uint32_t sign_pattern = num_signs
            ? (uint32_t)(decode_bins_ep_impl(self, num_signs) << (32 - num_signs))
            : 0;
        int64_t sum_abs = 0;
        for (int k = 0; k < num_signs; k++) {
            int32_t abs_c = coeff[sig_blk_pos[k]];
            sum_abs += abs_c;
            if (sign_pattern & 0x80000000u)
                coeff[sig_blk_pos[k]] = -abs_c;
            sign_pattern <<= 1;
        }
        if (num_nonzero > num_signs) {
            int32_t abs_c = coeff[sig_blk_pos[num_signs]];
            sum_abs += abs_c;
            if (sum_abs & 1)
                coeff[sig_blk_pos[num_signs]] = -abs_c;
        }
    }
    PyBuffer_Release(&cb);
    PyBuffer_Release(&sb);
    PyBuffer_Release(&scgb);
    return Py_BuildValue("ii", last, violates_mts);
}

/* transform-skip residual coding (residual_codingTS, CABACReader.cpp:3358) */
static PyObject *nc_rc_block_ts(NativeCabac *self, PyObject *args)
{
    PyObject *coeff_o, *scan_o, *scan_cg_o;
    int w, h, log2_cg_w, log2_cg_h, bdpcm;
    int ts_sig_cg, ts_sig, ts_sign, ts_lrg1, ts_par, ts_gtx;
    if (!PyArg_ParseTuple(args, "OOOiiiiiiiiiii",
                          &coeff_o, &scan_o, &scan_cg_o,
                          &w, &h, &log2_cg_w, &log2_cg_h, &bdpcm,
                          &ts_sig_cg, &ts_sig, &ts_sign, &ts_lrg1, &ts_par, &ts_gtx))
        return NULL;
    Py_buffer cb, sb, scgb;
    if (PyObject_GetBuffer(coeff_o, &cb, PyBUF_WRITABLE) < 0) return NULL;
    if (PyObject_GetBuffer(scan_o, &sb, PyBUF_SIMPLE) < 0) { PyBuffer_Release(&cb); return NULL; }
    if (PyObject_GetBuffer(scan_cg_o, &scgb, PyBUF_SIMPLE) < 0) { PyBuffer_Release(&cb); PyBuffer_Release(&sb); return NULL; }
    const int32_t *scan = (const int32_t *)sb.buf;
    const int32_t *scan_cg = (const int32_t *)scgb.buf;
    int32_t *coeff = (int32_t *)cb.buf;
    int log2_cg_size = log2_cg_w + log2_cg_h;
    int wig = ((w < 32 ? w : 32) >> log2_cg_w);
    int hig = ((h < 32 ? h : 32) >> log2_cg_h);
    int max_num_coeff = w * h;
    int num_ctx_bins = (max_num_coeff * 7) >> 2;
    uint8_t sig_group_flags[256];
    memset(sig_group_flags, 0, sizeof(sig_group_flags));
    int any_group = 0;
    int n_subsets = ((max_num_coeff - 1) >> log2_cg_size) + 1;
    for (int subset = 0; subset < n_subsets; subset++) {
        int sub_set_pos = scan_cg[subset * 3];
        int cg_pos_y = sub_set_pos / wig;
        int cg_pos_x = sub_set_pos - cg_pos_y * wig;
        int min_sub_pos = subset << log2_cg_size;          /* python first_sig_pos */
        int max_sub_pos = min_sub_pos + (1 << log2_cg_size) - 1;
        int is_last_subset = subset == n_subsets - 1;
        int sig_group = is_last_subset && !any_group;
        if (!sig_group) {
            int sig_left = cg_pos_x > 0 ? sig_group_flags[sub_set_pos - 1] : 0;
            int sig_above = cg_pos_y > 0 ? sig_group_flags[sub_set_pos - wig] : 0;
            sig_group = decode_bin_impl(self, ts_sig_cg + sig_left + sig_above);
        }
        if (sig_group) {
            sig_group_flags[sub_set_pos] = 1;
            any_group = 1;
        } else {
            continue;
        }
        int first_sig_pos = min_sub_pos;
        int end_pos = max_sub_pos;
        uint64_t sign_pattern = 0;
        int num_nonzero = 0;
        int sig_blk_pos[16];
        int last_pass1 = -1, last_pass2 = -1;
        int pos = first_sig_pos;
        int infer_sig_pos = end_pos;
        while (pos <= end_pos && num_ctx_bins >= 4) {
            int blk_pos = scan[pos * 3];
            int x = scan[pos * 3 + 1];
            int y = scan[pos * 3 + 2];
            int base = x + y * w;
            int sig = (num_nonzero == 0 && pos == infer_sig_pos);
            if (!sig) {
                int num_pos = 0;
                if (x > 0) num_pos += coeff[base - 1] ? 1 : 0;
                if (y > 0) num_pos += coeff[base - w] ? 1 : 0;
                sig = decode_bin_impl(self, ts_sig + num_pos);
                num_ctx_bins -= 1;
            }
            if (sig) {
                int right = 0, below = 0;
                if (x > 0) right = coeff[base - 1] > 0 ? 1 : (coeff[base - 1] < 0 ? -1 : 0);
                if (y > 0) below = coeff[base - w] > 0 ? 1 : (coeff[base - w] < 0 ? -1 : 0);
                int c;
                if ((right == 0 && below == 0) || right * below < 0) c = 0;
                else if (right >= 0 && below >= 0) c = 1;
                else c = 2;
                if (bdpcm) c += 3;
                int sign = decode_bin_impl(self, ts_sign + c);
                num_ctx_bins -= 1;
                sign_pattern += (uint64_t)sign << num_nonzero;
                sig_blk_pos[num_nonzero] = blk_pos;
                num_nonzero += 1;
                int lrg1_pos;
                if (bdpcm) {
                    lrg1_pos = 3;
                } else {
                    lrg1_pos = 0;
                    if (x > 0) lrg1_pos += coeff[base - 1] ? 1 : 0;
                    if (y > 0) lrg1_pos += coeff[base - w] ? 1 : 0;
                }
                int gt1 = decode_bin_impl(self, ts_lrg1 + lrg1_pos);
                num_ctx_bins -= 1;
                int par = 0;
                if (gt1) {
                    par = decode_bin_impl(self, ts_par);
                    num_ctx_bins -= 1;
                }
                coeff[blk_pos] = (sign ? -1 : 1) * (1 + par + gt1);
            }
            last_pass1 = pos;
            pos += 1;
        }
        /* 2nd pass: gt2 bins */
        pos = first_sig_pos;
        while (pos <= end_pos && num_ctx_bins >= 4) {
            int blk_pos = scan[pos * 3];
            int cutoff = 2;
            for (int i = 0; i < 4; i++) {
                if (coeff[blk_pos] < 0) coeff[blk_pos] = -coeff[blk_pos];
                if (coeff[blk_pos] >= cutoff) {
                    int gt2 = decode_bin_impl(self, ts_gtx + (cutoff >> 1));
                    coeff[blk_pos] += gt2 << 1;
                    num_ctx_bins -= 1;
                }
                cutoff += 2;
            }
            last_pass2 = pos;
            pos += 1;
        }
        /* 3rd pass: rice remainders + trailing sig/sign */
        for (pos = first_sig_pos; pos <= end_pos; pos++) {
            int blk_pos = scan[pos * 3];
            int cutoff = pos <= last_pass2 ? 10 : (pos <= last_pass1 ? 2 : 0);
            if (coeff[blk_pos] < 0) coeff[blk_pos] = -coeff[blk_pos];
            if (coeff[blk_pos] >= cutoff) {
                uint64_t rem = decode_rem_abs_ep_impl(self, 1, COEF_REMAIN_BIN_REDUCTION, 15);
                coeff[blk_pos] += (int32_t)(pos <= last_pass1 ? (rem << 1) : rem);
                if (coeff[blk_pos] && pos > last_pass1) {
                    int sign = decode_bin_ep_impl(self);
                    sign_pattern += (uint64_t)sign << num_nonzero;
                    sig_blk_pos[num_nonzero] = blk_pos;
                    num_nonzero += 1;
                }
            }
            if (!bdpcm && cutoff) {
                if (coeff[blk_pos] > 0) {
                    int x = scan[pos * 3 + 1];
                    int y = scan[pos * 3 + 2];
                    int base = x + y * w;
                    int32_t right = x > 0 ? coeff[base - 1] : 0;
                    int32_t below = y > 0 ? coeff[base - w] : 0;
                    int32_t ar = right < 0 ? -right : right;
                    int32_t ab = below < 0 ? -below : below;
                    int32_t pred1 = ar > ab ? ar : ab;
                    int32_t abs_c = coeff[blk_pos];
                    if (abs_c == 1 && pred1 > 0)
                        coeff[blk_pos] = pred1;
                    else
                        coeff[blk_pos] = abs_c - (abs_c <= pred1 ? 1 : 0);
                }
            }
        }
        for (int k = 0; k < num_nonzero; k++) {
            int32_t abs_c = coeff[sig_blk_pos[k]];
            coeff[sig_blk_pos[k]] = (sign_pattern & 1) ? -abs_c : abs_c;
            sign_pattern >>= 1;
        }
    }
    PyBuffer_Release(&cb);
    PyBuffer_Release(&sb);
    PyBuffer_Release(&scgb);
    Py_RETURN_NONE;
}

/* ------------------------------------------------------------------ */
/* Residual-coding fractional-bit ESTIMATION (encoder RD trials) —     */
/* exact twin of vtm_jax/encoder/cabac_writer.py residual_coding on a  */
/* BitEstimator (EncoderLib/CABACWriter.cpp residual_coding +          */
/* BinEncoder.h TBitEstimator): context-state updates + frac-bit LUT,  */
/* no arithmetic words.  One call per TU component.                    */
/* ------------------------------------------------------------------ */

typedef struct {
    int32_t *s0, *s1;
    const int32_t *r0, *r1;
    int64_t fb;
} EstState;

static inline void est_bin(EstState *e, int bin, int i)
{
    int32_t s0 = e->s0[i], s1 = e->s1[i];
    int state = (int)((uint32_t)(s0 + s1) >> 8);
    e->fb += g_frac_lut[state * 2 + bin];
    int32_t r0 = e->r0[i], r1 = e->r1[i];
    s0 -= (s0 >> r0) & MASK_0;
    s1 -= (s1 >> r1) & MASK_1;
    if (bin) {
        s0 += (0x7FFF >> r0) & MASK_0;
        s1 += (0x7FFF >> r1) & MASK_1;
    }
    e->s0[i] = s0;
    e->s1[i] = s1;
}

static inline int est_rem_len(int64_t bins, int rice, int cutoff, int maxlog)
{
    if (bins < ((int64_t)cutoff << rice))
        return (int)(bins >> rice) + 1 + rice;
    int max_prefix_len = 32 - cutoff - maxlog;
    int64_t code_value = (bins >> rice) - cutoff;
    int prefix_len = 0, suffix_len;
    if (code_value >= (1ll << max_prefix_len) - 1) {
        prefix_len = max_prefix_len;
        suffix_len = maxlog;
    } else {
        while (code_value > (2ll << prefix_len) - 2)
            prefix_len++;
        suffix_len = prefix_len + rice + 1;
    }
    return prefix_len + cutoff + suffix_len;
}

static PyObject *mod_rc_est(PyObject *mod, PyObject *args)
{
    PyObject *ctx, *coeff_o, *scan_o, *scan_cg_o;
    int w, h, log2_cg_w, log2_cg_h, ch;
    int state_trans, reg_bin_limit;
    int max_last_x, max_last_y, last_off_x, last_off_y, last_shift_x, last_shift_y;
    int ctx_last_x, ctx_last_y, sig0, sig1, sig2, par_set, gtx0, gtx1, sig_cg;
    if (!PyArg_ParseTuple(args, "OOOOiiiiiiiiiiiiiiiiiiiiii",
                          &ctx, &coeff_o, &scan_o, &scan_cg_o,
                          &w, &h, &log2_cg_w, &log2_cg_h, &ch,
                          &state_trans, &reg_bin_limit,
                          &max_last_x, &max_last_y, &last_off_x, &last_off_y,
                          &last_shift_x, &last_shift_y,
                          &ctx_last_x, &ctx_last_y, &sig0, &sig1, &sig2,
                          &par_set, &gtx0, &gtx1, &sig_cg))
        return NULL;
    Py_buffer bs0, bs1, br0, br1, cb, sb, scgb;
    PyObject *a;
    a = PyObject_GetAttrString(ctx, "state0");
    if (!a || PyObject_GetBuffer(a, &bs0, PyBUF_WRITABLE) < 0) { Py_XDECREF(a); return NULL; }
    Py_DECREF(a);
    a = PyObject_GetAttrString(ctx, "state1");
    if (!a || PyObject_GetBuffer(a, &bs1, PyBUF_WRITABLE) < 0) { Py_XDECREF(a); PyBuffer_Release(&bs0); return NULL; }
    Py_DECREF(a);
    a = PyObject_GetAttrString(ctx, "rate0");
    if (!a || PyObject_GetBuffer(a, &br0, PyBUF_SIMPLE) < 0) { Py_XDECREF(a); PyBuffer_Release(&bs0); PyBuffer_Release(&bs1); return NULL; }
    Py_DECREF(a);
    a = PyObject_GetAttrString(ctx, "rate1");
    if (!a || PyObject_GetBuffer(a, &br1, PyBUF_SIMPLE) < 0) { Py_XDECREF(a); PyBuffer_Release(&bs0); PyBuffer_Release(&bs1); PyBuffer_Release(&br0); return NULL; }
    Py_DECREF(a);
    if (PyObject_GetBuffer(coeff_o, &cb, PyBUF_SIMPLE) < 0) goto fail_ctx;
    if (PyObject_GetBuffer(scan_o, &sb, PyBUF_SIMPLE) < 0) { PyBuffer_Release(&cb); goto fail_ctx; }
    if (PyObject_GetBuffer(scan_cg_o, &scgb, PyBUF_SIMPLE) < 0) { PyBuffer_Release(&cb); PyBuffer_Release(&sb); goto fail_ctx; }

    {
    EstState e = {(int32_t *)bs0.buf, (int32_t *)bs1.buf,
                  (const int32_t *)br0.buf, (const int32_t *)br1.buf, 0};
    RcCtx rc;
    memset(rc.sig_group_flags, 0, sizeof(rc.sig_group_flags));
    rc.w = w; rc.h = h;
    rc.log2_cg_w = log2_cg_w; rc.log2_cg_h = log2_cg_h;
    rc.log2_cg_size = log2_cg_w + log2_cg_h;
    rc.wig = ((w < 32 ? w : 32) >> log2_cg_w);
    rc.hig = ((h < 32 ? h : 32) >> log2_cg_h);
    rc.ch = ch;
    rc.scan = (const int32_t *)sb.buf;
    rc.scan_cg = (const int32_t *)scgb.buf;
    rc.coeff = (int32_t *)cb.buf;
    rc.sig_set[0] = sig0; rc.sig_set[1] = sig1; rc.sig_set[2] = sig2;
    rc.par_set = par_set; rc.gtx_set[0] = gtx0; rc.gtx_set[1] = gtx1;
    rc.sig_cg_set = sig_cg;
    rc.tmpl_diag = -1; rc.tmpl_sum1 = -1;
    const int32_t *coeff = rc.coeff;
    int max_num_coeff = w * h;

    int last = -1;
    for (int sp = max_num_coeff - 1; sp >= 0; sp--)
        if (coeff[rc.scan[sp * 3]]) { last = sp; break; }
    if (last < 0) {
        PyBuffer_Release(&cb); PyBuffer_Release(&sb); PyBuffer_Release(&scgb);
        PyBuffer_Release(&bs0); PyBuffer_Release(&bs1);
        PyBuffer_Release(&br0); PyBuffer_Release(&br1);
        PyErr_SetString(PyExc_ValueError, "rc_est on all-zero block");
        return NULL;
    }
    rc.scan_pos_last = last;

    /* last significant position */
    {
        int pos_x = rc.scan[last * 3 + 1];
        int pos_y = rc.scan[last * 3 + 2];
        int gx = g_group_idx[pos_x], gy = g_group_idx[pos_y];
        for (int i = 0; i < gx; i++)
            est_bin(&e, 1, ctx_last_x + last_off_x + (i >> last_shift_x));
        if (gx < max_last_x)
            est_bin(&e, 0, ctx_last_x + last_off_x + (gx >> last_shift_x));
        for (int i = 0; i < gy; i++)
            est_bin(&e, 1, ctx_last_y + last_off_y + (i >> last_shift_y));
        if (gy < max_last_y)
            est_bin(&e, 0, ctx_last_y + last_off_y + (gy >> last_shift_y));
        if (gx > 3) e.fb += (int64_t)((gx - 2) >> 1) << 15;
        if (gy > 3) e.fb += (int64_t)((gy - 2) >> 1) << 15;
    }

    int state = 0;
    int rem_limit = reg_bin_limit;
    for (int subset = last >> rc.log2_cg_size; subset >= 0; subset--) {
        rc_init_subblock(&rc, subset, 0);
        int min_sub_pos = rc.min_sub_pos;
        int is_last_sb = (last >> rc.log2_cg_size) == subset;
        int first_sig_pos = is_last_sb ? last : rc.max_sub_pos;
        int sig_group = 0;
        for (int sp = min_sub_pos; sp <= rc.max_sub_pos; sp++)
            if (coeff[rc.scan[sp * 3]]) { sig_group = 1; break; }
        if (!(is_last_sb || subset == 0)) {
            int sig_right = (rc.cg_pos_x + 1 < rc.wig) ? rc.sig_group_flags[rc.sub_set_pos + 1] : 0;
            int sig_lower = (rc.cg_pos_y + 1 < rc.hig) ? rc.sig_group_flags[rc.sub_set_pos + rc.wig] : 0;
            est_bin(&e, sig_group, rc.sig_cg_set + ((sig_right || sig_lower) ? 1 : 0));
            if (!sig_group)
                continue;
        }
        /* last + DC subblocks: coded_sub_block_flag inferred 1; an
         * all-zero DC subblock still codes 16 zero sig flags */
        rc.sig_group_flags[rc.sub_set_pos] = 1;
        int infer_sig_pos = (first_sig_pos != last)
                                ? (subset != 0 ? min_sub_pos : -1)
                                : first_sig_pos;
        int num_nonzero = 0;
        int rem_reg_bins = rem_limit;
        int pos = first_sig_pos;
        while (pos >= min_sub_pos && rem_reg_bins >= 4) {
            int blk_pos = rc.scan[pos * 3];
            int32_t level = coeff[blk_pos];
            if (level < 0) level = -level;
            int sig = level != 0;
            int inferred = (num_nonzero == 0 && pos == infer_sig_pos);
            if (!inferred) {
                int sig_ctx = rc_sig_ctx_id_abs(&rc, NULL, pos, state);
                est_bin(&e, sig, sig_ctx);
                rem_reg_bins -= 1;
            } else if (pos != last) {
                rc_sig_ctx_id_abs(&rc, NULL, pos, state);
            }
            if (sig) {
                int off = rc_ctx_offset_abs(&rc);
                num_nonzero += 1;
                int gt1 = level > 1;
                est_bin(&e, gt1, rc.gtx_set[1] + off);
                rem_reg_bins -= 1;
                if (gt1) {
                    est_bin(&e, (level - 2) & 1, rc.par_set + off);
                    rem_reg_bins -= 1;
                    est_bin(&e, level > 3, rc.gtx_set[0] + off);
                    rem_reg_bins -= 1;
                }
            }
            state = (state_trans >> ((state << 2) + ((level & 1) << 1))) & 3;
            pos -= 1;
        }
        int first_pos_mode2 = pos;
        rem_limit = rem_reg_bins;
        for (int sp = first_sig_pos; sp > first_pos_mode2; sp--) {
            int32_t level = coeff[rc.scan[sp * 3]];
            if (level < 0) level = -level;
            int sum_all = rc_template_abs_sum(&rc, sp, 4);
            int rice = g_go_rice[sum_all];
            if (level >= 4)
                e.fb += (int64_t)est_rem_len((level - 4) >> 1, rice,
                                             COEF_REMAIN_BIN_REDUCTION, 15) << 15;
        }
        for (int sp = first_pos_mode2; sp >= min_sub_pos; sp--) {
            int32_t level = coeff[rc.scan[sp * 3]];
            if (level < 0) level = -level;
            int sum_all = rc_template_abs_sum(&rc, sp, 0);
            int rice = g_go_rice[sum_all];
            int64_t pos0 = (int64_t)(state < 2 ? 1 : 2) << rice;
            int64_t rem = level == 0 ? pos0 : (level <= pos0 ? level - 1 : level);
            e.fb += (int64_t)est_rem_len(rem, rice, COEF_REMAIN_BIN_REDUCTION, 15) << 15;
            state = (state_trans >> ((state << 2) + ((level & 1) << 1))) & 3;
        }
        int ns = 0;
        for (int sp = first_sig_pos; sp >= min_sub_pos; sp--)
            if (coeff[rc.scan[sp * 3]]) ns++;
        e.fb += (int64_t)ns << 15;
    }
    PyBuffer_Release(&cb); PyBuffer_Release(&sb); PyBuffer_Release(&scgb);
    PyBuffer_Release(&bs0); PyBuffer_Release(&bs1);
    PyBuffer_Release(&br0); PyBuffer_Release(&br1);
    return Py_BuildValue("Li", (long long)e.fb, last);
    }
fail_ctx:
    PyBuffer_Release(&bs0); PyBuffer_Release(&bs1);
    PyBuffer_Release(&br0); PyBuffer_Release(&br1);
    return NULL;
}

static PyObject *nc_get_ctx(NativeCabac *self, void *closure)
{
    Py_INCREF(self->ctx_obj);
    return self->ctx_obj;
}

static int nc_set_ctx(NativeCabac *self, PyObject *value, void *closure)
{
    return bind_ctx(self, value);
}

static PyMemberDef nc_members[] = {
    {"pos", T_PYSSIZET, offsetof(NativeCabac, pos), 0, "byte position"},
    {"bits_needed", T_INT, offsetof(NativeCabac, bits_needed), 0, ""},
    {"trace", T_OBJECT, offsetof(NativeCabac, trace), 0, ""},
    {"trace_count", T_LONG, offsetof(NativeCabac, trace_count), 0, ""},
    {NULL}
};

static PyGetSetDef nc_getset[] = {
    {"ctx", (getter)nc_get_ctx, (setter)nc_set_ctx, "context models", NULL},
    {NULL}
};

static PyMethodDef nc_methods[] = {
    {"start", (PyCFunction)nc_start, METH_NOARGS, ""},
    {"decode_bin", (PyCFunction)nc_decode_bin, METH_O, ""},
    {"decode_bin_ep", (PyCFunction)nc_decode_bin_ep, METH_NOARGS, ""},
    {"decode_bins_ep", (PyCFunction)nc_decode_bins_ep, METH_O, ""},
    {"decode_rem_abs_ep", (PyCFunction)nc_decode_rem_abs_ep, METH_VARARGS, ""},
    {"decode_bin_trm", (PyCFunction)nc_decode_bin_trm, METH_NOARGS, ""},
    {"align", (PyCFunction)nc_align, METH_NOARGS, ""},
    {"rc_block", (PyCFunction)nc_rc_block, METH_VARARGS,
     "residual_coding of one TU component (non-TS), syntax level"},
    {"rc_block_ts", (PyCFunction)nc_rc_block_ts, METH_VARARGS,
     "residual_codingTS of one TU component"},
    {NULL}
};

static PyMethodDef mod_methods[] = {
    {"set_tables", (PyCFunction)mod_set_tables, METH_VARARGS,
     "register groupIdx / minInGroup / goRiceParsCoeff ROM tables"},
    {"set_frac_table", (PyCFunction)mod_set_frac_table, METH_O,
     "register the (256,2) int64 m_binFracBits estimator LUT"},
    {"rc_est", (PyCFunction)mod_rc_est, METH_VARARGS,
     "fractional-bit estimate of residual_coding for one TU component"},
    {NULL}
};

static PyTypeObject NativeCabacType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "_cabac_native.NativeCabac",
    .tp_basicsize = sizeof(NativeCabac),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_new = PyType_GenericNew,
    .tp_init = (initproc)nc_init,
    .tp_dealloc = (destructor)nc_dealloc,
    .tp_methods = nc_methods,
    .tp_members = nc_members,
    .tp_getset = nc_getset,
};

static PyModuleDef cabac_module = {
    PyModuleDef_HEAD_INIT, "_cabac_native", NULL, -1, mod_methods
};

PyMODINIT_FUNC PyInit__cabac_native(void)
{
    PyObject *m;
    if (PyType_Ready(&NativeCabacType) < 0)
        return NULL;
    m = PyModule_Create(&cabac_module);
    if (!m)
        return NULL;
    Py_INCREF(&NativeCabacType);
    PyModule_AddObject(m, "NativeCabac", (PyObject *)&NativeCabacType);
    return m;
}
