/* Native Avro datum decoder (a copy of photon_ml_tpu/native/_avro_native.c,
 * built by photon_ml_tpu_torch/native/__init__.py).
 *
 * Replaces the pure-python read_datum interpreter (io/avro_codec.py) on the
 * ingest hot path: the schema is compiled (python side) into a flat int64
 * "program", and this module decodes a whole decompressed container block
 * into python objects in one C call (decode_block), or straight into CSR
 * triplets and label/offset/weight arrays for the training-example schema
 * family (decode_training_block, data/fast_ingest.py and
 * data/block_stream.py).
 *
 * Program encoding (int64 slots, node = index into the array):
 *   NULL    [0]
 *   BOOLEAN [1]
 *   LONG    [2]            (int and long)
 *   FLOAT   [3]
 *   DOUBLE  [4]
 *   BYTES   [5]
 *   STRING  [6]
 *   FIXED   [7, size]
 *   ENUM    [8, nsyms, sym_string_id...]
 *   UNION   [9, nbranches, child_idx...]
 *   ARRAY   [10, child_idx]
 *   MAP     [11, child_idx]
 *   RECORD  [12, nfields, (name_string_id, child_idx)...]
 *
 * String ids index a python tuple of interned str objects passed per call.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>

typedef struct {
    const char *data;
    Py_ssize_t len;
    Py_ssize_t off;
    const int64_t *prog;
    Py_ssize_t prog_len;
    PyObject *strings; /* tuple */
} DecState;

static int read_long_raw(DecState *st, int64_t *out) {
    uint64_t acc = 0;
    int shift = 0;
    while (1) {
        if (st->off >= st->len) {
            PyErr_SetString(PyExc_ValueError, "truncated varint");
            return -1;
        }
        uint8_t b = (uint8_t)st->data[st->off++];
        acc |= ((uint64_t)(b & 0x7f)) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
        if (shift > 63) {
            PyErr_SetString(PyExc_ValueError, "varint too long");
            return -1;
        }
    }
    /* zigzag */
    *out = (int64_t)(acc >> 1) ^ -((int64_t)(acc & 1));
    return 0;
}

static int need(DecState *st, Py_ssize_t n) {
    /* n > len - off, not off + n > len: the latter signed-overflows for
     * hostile varint lengths near PY_SSIZE_T_MAX (UB on untrusted input). */
    if (n < 0 || n > st->len - st->off) {
        PyErr_SetString(PyExc_ValueError, "truncated datum");
        return -1;
    }
    return 0;
}

static PyObject *get_string(DecState *st, int64_t id) {
    PyObject *s = PyTuple_GetItem(st->strings, (Py_ssize_t)id);
    return s; /* borrowed */
}

static PyObject *decode_node(DecState *st, Py_ssize_t node);

static PyObject *decode_blocked(DecState *st, Py_ssize_t child, int is_map) {
    PyObject *out = is_map ? PyDict_New() : PyList_New(0);
    if (!out) return NULL;
    while (1) {
        int64_t n;
        if (read_long_raw(st, &n) < 0) goto fail;
        if (n == 0) return out;
        if (n < 0) {
            int64_t sz;
            if (read_long_raw(st, &sz) < 0) goto fail;
            n = -n;
        }
        for (int64_t i = 0; i < n; i++) {
            if (is_map) {
                int64_t klen;
                if (read_long_raw(st, &klen) < 0) goto fail;
                if (klen < 0 || need(st, (Py_ssize_t)klen) < 0) {
                    if (klen < 0)
                        PyErr_SetString(PyExc_ValueError, "negative length");
                    goto fail;
                }
                PyObject *k = PyUnicode_FromStringAndSize(
                    st->data + st->off, (Py_ssize_t)klen);
                st->off += (Py_ssize_t)klen;
                if (!k) goto fail;
                PyObject *v = decode_node(st, child);
                if (!v) { Py_DECREF(k); goto fail; }
                int rc = PyDict_SetItem(out, k, v);
                Py_DECREF(k);
                Py_DECREF(v);
                if (rc < 0) goto fail;
            } else {
                PyObject *v = decode_node(st, child);
                if (!v) goto fail;
                if (PyList_Append(out, v) < 0) { Py_DECREF(v); goto fail; }
                Py_DECREF(v);
            }
        }
    }
fail:
    Py_DECREF(out);
    return NULL;
}

static PyObject *decode_node(DecState *st, Py_ssize_t node) {
    if (node < 0 || node >= st->prog_len) {
        PyErr_SetString(PyExc_ValueError, "program index out of range");
        return NULL;
    }
    int64_t op = st->prog[node];
    switch (op) {
    case 0: /* null */
        Py_RETURN_NONE;
    case 1: { /* boolean */
        if (need(st, 1) < 0) return NULL;
        int v = st->data[st->off++] == 1;
        if (v) Py_RETURN_TRUE; else Py_RETURN_FALSE;
    }
    case 2: { /* long */
        int64_t v;
        if (read_long_raw(st, &v) < 0) return NULL;
        return PyLong_FromLongLong((long long)v);
    }
    case 3: { /* float */
        if (need(st, 4) < 0) return NULL;
        float f;
        memcpy(&f, st->data + st->off, 4);
        st->off += 4;
        return PyFloat_FromDouble((double)f);
    }
    case 4: { /* double */
        if (need(st, 8) < 0) return NULL;
        double d;
        memcpy(&d, st->data + st->off, 8);
        st->off += 8;
        return PyFloat_FromDouble(d);
    }
    case 5: { /* bytes */
        int64_t n;
        if (read_long_raw(st, &n) < 0) return NULL;
        if (n < 0) {
            PyErr_SetString(PyExc_ValueError, "negative length");
            return NULL;
        }
        if (need(st, (Py_ssize_t)n) < 0) return NULL;
        PyObject *b = PyBytes_FromStringAndSize(st->data + st->off,
                                                (Py_ssize_t)n);
        st->off += (Py_ssize_t)n;
        return b;
    }
    case 6: { /* string */
        int64_t n;
        if (read_long_raw(st, &n) < 0) return NULL;
        if (n < 0) {
            PyErr_SetString(PyExc_ValueError, "negative length");
            return NULL;
        }
        if (need(st, (Py_ssize_t)n) < 0) return NULL;
        PyObject *s = PyUnicode_FromStringAndSize(st->data + st->off,
                                                  (Py_ssize_t)n);
        st->off += (Py_ssize_t)n;
        return s;
    }
    case 7: { /* fixed */
        int64_t sz = st->prog[node + 1];
        if (need(st, (Py_ssize_t)sz) < 0) return NULL;
        PyObject *b = PyBytes_FromStringAndSize(st->data + st->off,
                                                (Py_ssize_t)sz);
        st->off += (Py_ssize_t)sz;
        return b;
    }
    case 8: { /* enum */
        int64_t nsyms = st->prog[node + 1];
        int64_t idx;
        if (read_long_raw(st, &idx) < 0) return NULL;
        if (idx < 0 || idx >= nsyms) {
            PyErr_SetString(PyExc_ValueError, "enum index out of range");
            return NULL;
        }
        PyObject *s = get_string(st, st->prog[node + 2 + idx]);
        if (!s) return NULL;
        Py_INCREF(s);
        return s;
    }
    case 9: { /* union */
        int64_t nb = st->prog[node + 1];
        int64_t idx;
        if (read_long_raw(st, &idx) < 0) return NULL;
        if (idx < 0 || idx >= nb) {
            PyErr_SetString(PyExc_ValueError, "union branch out of range");
            return NULL;
        }
        return decode_node(st, (Py_ssize_t)st->prog[node + 2 + idx]);
    }
    case 10: /* array */
        return decode_blocked(st, (Py_ssize_t)st->prog[node + 1], 0);
    case 11: /* map */
        return decode_blocked(st, (Py_ssize_t)st->prog[node + 1], 1);
    case 12: { /* record */
        int64_t nf = st->prog[node + 1];
        PyObject *d = PyDict_New();
        if (!d) return NULL;
        for (int64_t i = 0; i < nf; i++) {
            PyObject *name = get_string(st, st->prog[node + 2 + 2 * i]);
            if (!name) { Py_DECREF(d); return NULL; }
            PyObject *v = decode_node(
                st, (Py_ssize_t)st->prog[node + 2 + 2 * i + 1]);
            if (!v) { Py_DECREF(d); return NULL; }
            int rc = PyDict_SetItem(d, name, v);
            Py_DECREF(v);
            if (rc < 0) { Py_DECREF(d); return NULL; }
        }
        return d;
    }
    default:
        PyErr_Format(PyExc_ValueError, "bad opcode %lld", (long long)op);
        return NULL;
    }
}

/* Walk a datum without building objects (used to skip fields the
 * specialized training decoder doesn't care about). */
static int skip_node(DecState *st, Py_ssize_t node) {
    if (node < 0 || node >= st->prog_len) {
        PyErr_SetString(PyExc_ValueError, "program index out of range");
        return -1;
    }
    int64_t op = st->prog[node];
    int64_t n;
    switch (op) {
    case 0: return 0;
    case 1: return need(st, 1) < 0 ? -1 : (st->off += 1, 0);
    case 2: return read_long_raw(st, &n);
    case 3: return need(st, 4) < 0 ? -1 : (st->off += 4, 0);
    case 4: return need(st, 8) < 0 ? -1 : (st->off += 8, 0);
    case 5:
    case 6:
        if (read_long_raw(st, &n) < 0) return -1;
        if (need(st, (Py_ssize_t)n) < 0) return -1;
        st->off += (Py_ssize_t)n;
        return 0;
    case 7:
        if (need(st, (Py_ssize_t)st->prog[node + 1]) < 0) return -1;
        st->off += (Py_ssize_t)st->prog[node + 1];
        return 0;
    case 8: return read_long_raw(st, &n);
    case 9: {
        if (read_long_raw(st, &n) < 0) return -1;
        if (n < 0 || n >= st->prog[node + 1]) {
            PyErr_SetString(PyExc_ValueError, "union branch out of range");
            return -1;
        }
        return skip_node(st, (Py_ssize_t)st->prog[node + 2 + n]);
    }
    case 10:
    case 11: {
        Py_ssize_t child = (Py_ssize_t)st->prog[node + 1];
        while (1) {
            if (read_long_raw(st, &n) < 0) return -1;
            if (n == 0) return 0;
            if (n < 0) {
                int64_t sz;
                if (read_long_raw(st, &sz) < 0) return -1;
                n = -n;
            }
            for (int64_t i = 0; i < n; i++) {
                if (op == 11) { /* map key */
                    int64_t klen;
                    if (read_long_raw(st, &klen) < 0) return -1;
                    if (need(st, (Py_ssize_t)klen) < 0) return -1;
                    st->off += (Py_ssize_t)klen;
                }
                if (skip_node(st, child) < 0) return -1;
            }
        }
    }
    case 12: {
        int64_t nf = st->prog[node + 1];
        for (int64_t i = 0; i < nf; i++)
            if (skip_node(st, (Py_ssize_t)st->prog[node + 2 + 2 * i + 1]) < 0)
                return -1;
        return 0;
    }
    default:
        PyErr_Format(PyExc_ValueError, "bad opcode %lld", (long long)op);
        return -1;
    }
}

/* ---- specialized TrainingExampleAvro block decoder ----------------------
 *
 * Layout (int64 array), computed python-side from the file's actual schema:
 *   [n_outer, (kind, aux) * n_outer, n_inner, (kind, aux) * n_inner]
 * outer kinds: 0 SKIP(aux=prog node), 1 UID(aux=null branch), 2 LABEL,
 *   3 WEIGHT(aux=null branch), 4 OFFSET(aux=null branch), 5 FEATURES,
 *   6 METADATA(aux=null branch)
 * inner (feature record) kinds: 0 SKIP(aux=prog node), 10 NAME,
 *   11 TERM(aux=null branch), 12 VALUE
 */

typedef struct { double *p; Py_ssize_t n, cap; } DBuf;
typedef struct { int64_t *p; Py_ssize_t n, cap; } LBuf;

static int dbuf_push(DBuf *b, double v) {
    if (b->n == b->cap) {
        Py_ssize_t nc = b->cap ? b->cap * 2 : 1024;
        double *np_ = (double *)PyMem_Realloc(b->p, nc * sizeof(double));
        if (!np_) { PyErr_NoMemory(); return -1; }
        b->p = np_; b->cap = nc;
    }
    b->p[b->n++] = v;
    return 0;
}

static int lbuf_push(LBuf *b, int64_t v) {
    if (b->n == b->cap) {
        Py_ssize_t nc = b->cap ? b->cap * 2 : 1024;
        int64_t *np_ = (int64_t *)PyMem_Realloc(b->p, nc * sizeof(int64_t));
        if (!np_) { PyErr_NoMemory(); return -1; }
        b->p = np_; b->cap = nc;
    }
    b->p[b->n++] = v;
    return 0;
}

static PyObject *bytes_from_dbuf(DBuf *b) {
    return PyBytes_FromStringAndSize((const char *)b->p,
                                     b->n * (Py_ssize_t)sizeof(double));
}
static PyObject *bytes_from_lbuf(LBuf *b) {
    return PyBytes_FromStringAndSize((const char *)b->p,
                                     b->n * (Py_ssize_t)sizeof(int64_t));
}

static int read_str_span(DecState *st, const char **ptr, Py_ssize_t *len) {
    int64_t n;
    if (read_long_raw(st, &n) < 0) return -1;
    if (n < 0 || need(st, (Py_ssize_t)n) < 0) {
        if (n < 0) PyErr_SetString(PyExc_ValueError, "negative length");
        return -1;
    }
    *ptr = st->data + st->off;
    *len = (Py_ssize_t)n;
    st->off += (Py_ssize_t)n;
    return 0;
}

static int read_opt_double(DecState *st, int64_t null_branch, double dflt,
                           double *out) {
    int64_t br;
    if (read_long_raw(st, &br) < 0) return -1;
    if (br == null_branch) { *out = dflt; return 0; }
    if (need(st, 8) < 0) return -1;
    memcpy(out, st->data + st->off, 8);
    st->off += 8;
    return 0;
}

static PyObject *py_decode_training_block(PyObject *self, PyObject *args) {
    Py_buffer data, prog, layout;
    Py_ssize_t count;
    PyObject *index_dicts;   /* tuple of dict (str -> int) */
    PyObject *intercepts;    /* tuple of int, same length */
    PyObject *want_ids;      /* tuple of str id-type names */
    PyObject *collect_keys;  /* set to gather feature keys into, or None */
    const char *delim_utf8;
    Py_ssize_t delim_len;
    if (!PyArg_ParseTuple(args, "y*ny*y*O!O!O!s#O",
                          &data, &count, &prog, &layout,
                          &PyTuple_Type, &index_dicts,
                          &PyTuple_Type, &intercepts,
                          &PyTuple_Type, &want_ids,
                          &delim_utf8, &delim_len, &collect_keys))
        return NULL;
    if (collect_keys != Py_None && !PySet_Check(collect_keys)) {
        PyErr_SetString(PyExc_TypeError, "collect_keys must be a set or None");
        return NULL;
    }

    DecState st;
    st.data = (const char *)data.buf;
    st.len = data.len;
    st.off = 0;
    st.prog = (const int64_t *)prog.buf;
    st.prog_len = prog.len / (Py_ssize_t)sizeof(int64_t);
    st.strings = NULL;

    const int64_t *lay = (const int64_t *)layout.buf;
    Py_ssize_t n_outer = (Py_ssize_t)lay[0];
    const int64_t *outer = lay + 1;
    const int64_t *inner_hdr = lay + 1 + 2 * n_outer;
    Py_ssize_t n_inner = (Py_ssize_t)inner_hdr[0];
    const int64_t *inner = inner_hdr + 1;

    Py_ssize_t n_shards = PyTuple_GET_SIZE(index_dicts);
    Py_ssize_t n_ids = PyTuple_GET_SIZE(want_ids);

    DBuf labels = {0}, offsets = {0}, weights = {0};
    DBuf *vals = NULL;
    LBuf *cols = NULL, *rowlens = NULL;
    PyObject *uids = NULL, *ids_out = NULL, *result = NULL;
    char *keybuf = NULL;
    Py_ssize_t keycap = 0;

    vals = (DBuf *)PyMem_Calloc((size_t)n_shards, sizeof(DBuf));
    cols = (LBuf *)PyMem_Calloc((size_t)n_shards, sizeof(LBuf));
    rowlens = (LBuf *)PyMem_Calloc((size_t)n_shards, sizeof(LBuf));
    if (!vals || !cols || !rowlens) { PyErr_NoMemory(); goto done; }

    uids = PyList_New(0);
    if (!uids) goto done;
    ids_out = PyTuple_New(n_ids);
    if (!ids_out) goto done;
    for (Py_ssize_t i = 0; i < n_ids; i++) {
        PyObject *l = PyList_New(0);
        if (!l) goto done;
        PyTuple_SET_ITEM(ids_out, i, l);
    }

    if (count < 0) {
        PyErr_SetString(PyExc_ValueError, "negative record count in block");
        goto done;
    }

    for (Py_ssize_t rec = 0; rec < count; rec++) {
        int64_t row_start[16];
        if (n_shards > 16) {
            PyErr_SetString(PyExc_ValueError, "too many feature shards");
            goto done;
        }
        for (Py_ssize_t s = 0; s < n_shards; s++)
            row_start[s] = cols[s].n;
        int ids_seen_mask = 0;

        for (Py_ssize_t fi = 0; fi < n_outer; fi++) {
            int64_t kind = outer[2 * fi], aux = outer[2 * fi + 1];
            switch (kind) {
            case 0:
                if (skip_node(&st, (Py_ssize_t)aux) < 0) goto done;
                break;
            case 1: { /* uid: union[null, string] */
                int64_t br;
                if (read_long_raw(&st, &br) < 0) goto done;
                if (br == aux) {
                    if (PyList_Append(uids, Py_None) < 0) goto done;
                } else {
                    const char *p; Py_ssize_t l;
                    if (read_str_span(&st, &p, &l) < 0) goto done;
                    PyObject *s_ = PyUnicode_FromStringAndSize(p, l);
                    if (!s_) goto done;
                    int rc = PyList_Append(uids, s_);
                    Py_DECREF(s_);
                    if (rc < 0) goto done;
                }
                break;
            }
            case 2: { /* label double */
                double d;
                if (need(&st, 8) < 0) goto done;
                memcpy(&d, st.data + st.off, 8);
                st.off += 8;
                if (dbuf_push(&labels, d) < 0) goto done;
                break;
            }
            case 3: { /* weight */
                double d;
                if (read_opt_double(&st, aux, 1.0, &d) < 0) goto done;
                if (dbuf_push(&weights, d) < 0) goto done;
                break;
            }
            case 4: { /* offset */
                double d;
                if (read_opt_double(&st, aux, 0.0, &d) < 0) goto done;
                if (dbuf_push(&offsets, d) < 0) goto done;
                break;
            }
            case 5: { /* features array */
                int64_t nb;
                while (1) {
                    if (read_long_raw(&st, &nb) < 0) goto done;
                    if (nb == 0) break;
                    if (nb < 0) {
                        int64_t sz;
                        if (read_long_raw(&st, &sz) < 0) goto done;
                        nb = -nb;
                    }
                    for (int64_t k = 0; k < nb; k++) {
                        const char *name_p = NULL, *term_p = NULL;
                        Py_ssize_t name_l = 0, term_l = 0;
                        double value = 0.0;
                        for (Py_ssize_t gi = 0; gi < n_inner; gi++) {
                            int64_t gk = inner[2 * gi];
                            int64_t ga = inner[2 * gi + 1];
                            if (gk == 0) {
                                if (skip_node(&st, (Py_ssize_t)ga) < 0)
                                    goto done;
                            } else if (gk == 10) {
                                if (read_str_span(&st, &name_p, &name_l) < 0)
                                    goto done;
                            } else if (gk == 11) {
                                /* term: union[null,string] (aux = null
                                 * branch) or plain string (aux = -1).
                                 * A plain string has no branch tag and is
                                 * always present, so it must always be
                                 * consumed. */
                                int64_t br = -1;
                                if (ga >= 0 &&
                                    read_long_raw(&st, &br) < 0)
                                    goto done;
                                if ((ga < 0 || br != ga)
                                    && read_str_span(&st, &term_p,
                                                     &term_l) < 0)
                                    goto done;
                            } else { /* 12 value */
                                if (need(&st, 8) < 0) goto done;
                                memcpy(&value, st.data + st.off, 8);
                                st.off += 8;
                            }
                        }
                        Py_ssize_t kl = name_l + delim_len + term_l;
                        if (kl > keycap) {
                            char *nb_ = (char *)PyMem_Realloc(
                                keybuf, (size_t)(kl < 256 ? 256 : kl * 2));
                            if (!nb_) { PyErr_NoMemory(); goto done; }
                            keybuf = nb_;
                            keycap = kl < 256 ? 256 : kl * 2;
                        }
                        memcpy(keybuf, name_p, (size_t)name_l);
                        memcpy(keybuf + name_l, delim_utf8,
                               (size_t)delim_len);
                        if (term_l)
                            memcpy(keybuf + name_l + delim_len, term_p,
                                   (size_t)term_l);
                        PyObject *key = PyUnicode_FromStringAndSize(
                            keybuf, kl);
                        if (!key) goto done;
                        if (collect_keys != Py_None &&
                            PySet_Add(collect_keys, key) < 0) {
                            Py_DECREF(key);
                            goto done;
                        }
                        for (Py_ssize_t s = 0; s < n_shards; s++) {
                            PyObject *idx = PyDict_GetItem(
                                PyTuple_GET_ITEM(index_dicts, s), key);
                            if (idx) {
                                long long iv = PyLong_AsLongLong(idx);
                                if (iv == -1 && PyErr_Occurred()) {
                                    Py_DECREF(key);
                                    goto done;
                                }
                                if (lbuf_push(&cols[s], (int64_t)iv) < 0 ||
                                    dbuf_push(&vals[s], value) < 0) {
                                    Py_DECREF(key);
                                    goto done;
                                }
                            }
                        }
                        Py_DECREF(key);
                    }
                }
                break;
            }
            case 6: { /* metadataMap: union[null, map<string>] */
                int64_t br;
                if (read_long_raw(&st, &br) < 0) goto done;
                if (br == aux) break; /* null */
                int64_t nb;
                while (1) {
                    if (read_long_raw(&st, &nb) < 0) goto done;
                    if (nb == 0) break;
                    if (nb < 0) {
                        int64_t sz;
                        if (read_long_raw(&st, &sz) < 0) goto done;
                        nb = -nb;
                    }
                    for (int64_t k = 0; k < nb; k++) {
                        const char *kp, *vp;
                        Py_ssize_t klv, vlv;
                        if (read_str_span(&st, &kp, &klv) < 0) goto done;
                        if (read_str_span(&st, &vp, &vlv) < 0) goto done;
                        for (Py_ssize_t w = 0; w < n_ids; w++) {
                            PyObject *want = PyTuple_GET_ITEM(want_ids, w);
                            Py_ssize_t wl;
                            const char *wp = PyUnicode_AsUTF8AndSize(
                                want, &wl);
                            if (!wp) goto done;
                            if (wl == klv && memcmp(wp, kp,
                                                    (size_t)klv) == 0) {
                                PyObject *v = PyUnicode_FromStringAndSize(
                                    vp, vlv);
                                if (!v) goto done;
                                PyObject *lst =
                                    PyTuple_GET_ITEM(ids_out, w);
                                if (ids_seen_mask & (1 << w)) {
                                    /* duplicate map key in this record:
                                     * keep the last occurrence (matches
                                     * the pure-python dict semantics)
                                     * instead of appending twice and
                                     * shifting row alignment */
                                    if (PyList_SetItem(
                                            lst,
                                            PyList_GET_SIZE(lst) - 1,
                                            v) < 0)
                                        goto done;
                                } else {
                                    int rc = PyList_Append(lst, v);
                                    Py_DECREF(v);
                                    if (rc < 0) goto done;
                                    ids_seen_mask |= (1 << w);
                                }
                            }
                        }
                    }
                }
                break;
            }
            default:
                PyErr_Format(PyExc_ValueError, "bad layout kind %lld",
                             (long long)kind);
                goto done;
            }
        }

        if (n_ids && ids_seen_mask != (1 << n_ids) - 1) {
            /* mirror the pure-python error surface
             * (data/avro_reader.py): name the first absent id type */
            Py_ssize_t miss = 0;
            while (miss < n_ids && (ids_seen_mask & (1 << miss)))
                miss++;
            PyErr_Format(PyExc_ValueError,
                         "record is missing id type %R in metadataMap",
                         PyTuple_GET_ITEM(want_ids, miss));
            goto done;
        }
        for (Py_ssize_t s = 0; s < n_shards; s++) {
            long long ic = PyLong_AsLongLong(
                PyTuple_GET_ITEM(intercepts, s));
            if (ic == -1 && PyErr_Occurred()) goto done;
            if (ic >= 0) {
                if (lbuf_push(&cols[s], (int64_t)ic) < 0 ||
                    dbuf_push(&vals[s], 1.0) < 0)
                    goto done;
            }
            if (lbuf_push(&rowlens[s], cols[s].n - row_start[s]) < 0)
                goto done;
        }
    }

    if (st.off != st.len) {
        PyErr_SetString(PyExc_ValueError,
                        "trailing bytes after last record in block");
        goto done;
    }

    {
        PyObject *shard_out = PyTuple_New(n_shards);
        if (!shard_out) goto done;
        for (Py_ssize_t s = 0; s < n_shards; s++) {
            PyObject *v = bytes_from_dbuf(&vals[s]);
            PyObject *c = v ? bytes_from_lbuf(&cols[s]) : NULL;
            PyObject *r = c ? bytes_from_lbuf(&rowlens[s]) : NULL;
            if (!r) {
                Py_XDECREF(v); Py_XDECREF(c);
                Py_DECREF(shard_out);
                goto done;
            }
            PyObject *t = PyTuple_Pack(3, v, c, r);
            Py_DECREF(v); Py_DECREF(c); Py_DECREF(r);
            if (!t) { Py_DECREF(shard_out); goto done; }
            PyTuple_SET_ITEM(shard_out, s, t);
        }
        PyObject *lb = bytes_from_dbuf(&labels);
        PyObject *ob = lb ? bytes_from_dbuf(&offsets) : NULL;
        PyObject *wb = ob ? bytes_from_dbuf(&weights) : NULL;
        if (!wb) {
            Py_XDECREF(lb); Py_XDECREF(ob); Py_DECREF(shard_out);
            goto done;
        }
        result = PyTuple_Pack(6, lb, ob, wb, uids, shard_out, ids_out);
        Py_DECREF(lb); Py_DECREF(ob); Py_DECREF(wb); Py_DECREF(shard_out);
    }

done:
    PyMem_Free(keybuf);
    PyMem_Free(labels.p); PyMem_Free(offsets.p); PyMem_Free(weights.p);
    if (vals) for (Py_ssize_t s = 0; s < n_shards; s++) PyMem_Free(vals[s].p);
    if (cols) for (Py_ssize_t s = 0; s < n_shards; s++) PyMem_Free(cols[s].p);
    if (rowlens)
        for (Py_ssize_t s = 0; s < n_shards; s++) PyMem_Free(rowlens[s].p);
    PyMem_Free(vals); PyMem_Free(cols); PyMem_Free(rowlens);
    Py_XDECREF(uids);
    Py_XDECREF(ids_out);
    PyBuffer_Release(&data);
    PyBuffer_Release(&prog);
    PyBuffer_Release(&layout);
    return result;
}

static PyObject *py_decode_block(PyObject *self, PyObject *args) {
    Py_buffer data, prog;
    Py_ssize_t count, root;
    PyObject *strings;
    if (!PyArg_ParseTuple(args, "y*ny*nO!", &data, &count, &prog, &root,
                          &PyTuple_Type, &strings))
        return NULL;
    DecState st;
    st.data = (const char *)data.buf;
    st.len = data.len;
    st.off = 0;
    st.prog = (const int64_t *)prog.buf;
    st.prog_len = prog.len / (Py_ssize_t)sizeof(int64_t);
    st.strings = strings;

    PyObject *out = NULL;
    if (count < 0) {
        PyErr_SetString(PyExc_ValueError, "negative record count in block");
        goto done;
    }
    out = PyList_New(count);
    if (!out) goto done;
    for (Py_ssize_t i = 0; i < count; i++) {
        PyObject *rec = decode_node(&st, root);
        if (!rec) { Py_DECREF(out); out = NULL; goto done; }
        PyList_SET_ITEM(out, i, rec);
    }
    if (st.off != st.len) {
        PyErr_SetString(PyExc_ValueError,
                        "trailing bytes after last record in block");
        Py_DECREF(out);
        out = NULL;
    }
done:
    PyBuffer_Release(&data);
    PyBuffer_Release(&prog);
    return out;
}

static PyMethodDef Methods[] = {
    {"decode_block", py_decode_block, METH_VARARGS,
     "decode_block(payload, count, program, root, strings) -> list"},
    {"decode_training_block", py_decode_training_block, METH_VARARGS,
     "decode_training_block(payload, count, program, layout, index_dicts, "
     "intercepts, want_ids, delimiter, collect_keys) -> "
     "(labels, offsets, weights, uids, shard_triples, id_lists)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_avro_native", NULL, -1, Methods,
};

PyMODINIT_FUNC PyInit__avro_native(void) {
    return PyModule_Create(&moduledef);
}
