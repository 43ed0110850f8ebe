/* Native dependent-quantization trellis.
 *
 * C implementation of the 4-state Viterbi in vtm_jax/ops/quant.py
 * quant_dep (encoder counterpart of DepQuant.cpp:806-1008 / quant:1582,
 * re-designed: candidate levels per state around the half-step pre-quant,
 * SSD in the scaled coefficient domain + lambda * bin-count rate model,
 * state transitions from the normative table).  Levels returned here are
 * reconstructed through the normative dequant_dep, so the Python and C
 * trellises are interchangeable encoder policies.
 *
 * Built on demand by vtm_jax/native/__init__.py; quant_dep falls back to
 * the pure-Python Viterbi when the native build is unavailable.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>

#define DQ_STATE_TRANS 32040
#define INF 1e300

static inline int bitlen(long v) {
    int n = 0;
    while (v) { n++; v >>= 1; }
    return n;
}

static inline double dq_rate(long level) {
    if (level == 0) return 0.55;
    if (level == 1) return 3.0;       /* 2.0 + 1.0 */
    if (level <= 3) return 5.0;       /* 2.0 + 3.0 */
    long rem = (level - 4) >> 1;
    return 2.0 + 4.0 + 2.0 + (rem ? bitlen(rem) * 2.0 : 0.0);
}

/* trellis(u_int64[npos], lev_out_int32[npos], qbits, err_scale, lam)
 * -> 1 if levels were chosen, 0 if the all-zero block wins.
 * u holds scaled magnitudes in coding order (last .. DC); lev_out gets the
 * chosen |level| per position in the same order. */
static PyObject *trellis(PyObject *self, PyObject *args) {
    PyObject *u_obj, *lev_obj;
    int qbits;
    double err_scale, lam;
    if (!PyArg_ParseTuple(args, "OOidd", &u_obj, &lev_obj, &qbits,
                          &err_scale, &lam))
        return NULL;
    Py_buffer ub, lb;
    if (PyObject_GetBuffer(u_obj, &ub, PyBUF_CONTIG_RO) < 0) return NULL;
    if (PyObject_GetBuffer(lev_obj, &lb, PyBUF_CONTIG) < 0) {
        PyBuffer_Release(&ub);
        return NULL;
    }
    Py_ssize_t npos = ub.len / (Py_ssize_t)sizeof(int64_t);
    const int64_t *u = (const int64_t *)ub.buf;
    int32_t *lev = (int32_t *)lb.buf;
    int64_t half = 1ll << (qbits - 1);

    /* back[i][ns] = (prev_state << 24) | level */
    int32_t *back = (int32_t *)malloc((size_t)npos * 4 * sizeof(int32_t));
    if (!back) {
        PyBuffer_Release(&ub); PyBuffer_Release(&lb);
        return PyErr_NoMemory();
    }
    double cost[4] = {0.0, INF, INF, INF};
    double zero_run = 0.0;
    for (Py_ssize_t i = 0; i < npos; i++) {
        double up = (double)u[i];
        zero_run += up * up * err_scale;
        double ncost[4] = {INF, INF, INF, INF};
        int32_t *bk = back + i * 4;
        for (int s = 0; s < 4; s++) {
            double cs = cost[s];
            if (cs >= INF) continue;
            long hq = s >> 1;
            long l0 = (long)((u[i] + hq * half) >> qbits);
            long cands[3];
            int nc;
            if (l0 > 0) { cands[0] = 0; cands[1] = l0; cands[2] = l0 + 1; nc = 3; }
            else        { cands[0] = 0; cands[1] = 1; nc = 2; }
            for (int k = 0; k < nc; k++) {
                long lv = cands[k];
                if (i == 0 && lv == 0) continue;  /* last pos is significant */
                double e = lv > 0 ? up - (double)((2 * lv - hq) * half) : up;
                double c = cs + e * e * err_scale + lam * dq_rate(lv);
                int ns = (DQ_STATE_TRANS >> ((s << 2) + ((lv & 1) << 1))) & 3;
                if (c < ncost[ns]) {
                    ncost[ns] = c;
                    bk[ns] = (int32_t)((s << 24) | (int32_t)lv);
                }
            }
        }
        memcpy(cost, ncost, sizeof(cost));
    }
    int best_s = 0;
    for (int s = 1; s < 4; s++)
        if (cost[s] < cost[best_s]) best_s = s;
    int keep = cost[best_s] + lam * 4.0 < zero_run;
    memset(lev, 0, (size_t)npos * sizeof(int32_t));
    if (keep) {
        int s = best_s;
        for (Py_ssize_t i = npos - 1; i >= 0; i--) {
            int32_t b = back[i * 4 + s];
            lev[i] = b & 0xFFFFFF;
            s = (b >> 24) & 3;
        }
    }
    free(back);
    PyBuffer_Release(&ub);
    PyBuffer_Release(&lb);
    return PyLong_FromLong(keep);
}

static PyMethodDef methods[] = {
    {"trellis", trellis, METH_VARARGS,
     "4-state dep-quant Viterbi over scaled magnitudes"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef mod = {
    PyModuleDef_HEAD_INIT, "_depquant_native", NULL, -1, methods,
};

PyMODINIT_FUNC PyInit__depquant_native(void) { return PyModule_Create(&mod); }
