/* Fast length-prefixed frame codec for the telemetry wire.
 *
 * The aggregator's ingest path decodes every frame each rank sends each
 * tick; at pod scale (hundreds of ranks x many frames) the Python
 * struct/slice loop shows up.  This extension provides:
 *
 *   drain_frames(buffer: bytes, offset: int, max_frame: int)
 *       -> (frames: list[bytes], consumed: int)
 *     one pass over the buffer, returning all complete frames and the
 *     total consumed prefix (the caller compacts its rolling buffer).
 *     Raises ValueError on a frame length above max_frame.
 *
 *   pack_frames(bodies: sequence[bytes]) -> bytes
 *     one allocation for the whole batch: [len][body][len][body]...
 *
 * Framing: 4-byte big-endian length + body, identical to the Python
 * implementation in transport/tcp_transport.py (which remains the
 * fallback when the extension isn't built).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>
#include <stdint.h>

static uint32_t read_be32(const unsigned char *p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

static void write_be32(unsigned char *p, uint32_t v) {
    p[0] = (unsigned char)(v >> 24);
    p[1] = (unsigned char)(v >> 16);
    p[2] = (unsigned char)(v >> 8);
    p[3] = (unsigned char)v;
}

static PyObject *drain_frames(PyObject *self, PyObject *args) {
    Py_buffer view;
    Py_ssize_t offset;
    Py_ssize_t max_frame;
    if (!PyArg_ParseTuple(args, "y*nn", &view, &offset, &max_frame)) {
        return NULL;
    }
    const unsigned char *buf = (const unsigned char *)view.buf;
    Py_ssize_t len = view.len;
    if (offset < 0 || offset > len) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "offset out of range");
        return NULL;
    }
    PyObject *frames = PyList_New(0);
    if (frames == NULL) {
        PyBuffer_Release(&view);
        return NULL;
    }
    Py_ssize_t pos = offset;
    while (len - pos >= 4) {
        uint32_t n = read_be32(buf + pos);
        if ((Py_ssize_t)n > max_frame) {
            Py_DECREF(frames);
            PyBuffer_Release(&view);
            PyErr_Format(PyExc_ValueError,
                         "frame length %u exceeds bound %zd", n, max_frame);
            return NULL;
        }
        if (len - pos - 4 < (Py_ssize_t)n) {
            break; /* incomplete frame */
        }
        PyObject *frame =
            PyBytes_FromStringAndSize((const char *)(buf + pos + 4),
                                      (Py_ssize_t)n);
        if (frame == NULL) {
            Py_DECREF(frames);
            PyBuffer_Release(&view);
            return NULL;
        }
        if (PyList_Append(frames, frame) < 0) {
            Py_DECREF(frame);
            Py_DECREF(frames);
            PyBuffer_Release(&view);
            return NULL;
        }
        Py_DECREF(frame);
        pos += 4 + (Py_ssize_t)n;
    }
    PyBuffer_Release(&view);
    return Py_BuildValue("(Nn)", frames, pos);
}

static PyObject *pack_frames(PyObject *self, PyObject *args) {
    PyObject *seq_in;
    if (!PyArg_ParseTuple(args, "O", &seq_in)) {
        return NULL;
    }
    PyObject *seq = PySequence_Fast(seq_in, "pack_frames expects a sequence");
    if (seq == NULL) {
        return NULL;
    }
    Py_ssize_t count = PySequence_Fast_GET_SIZE(seq);
    Py_ssize_t total = 0;
    for (Py_ssize_t i = 0; i < count; i++) {
        PyObject *item = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyBytes_Check(item)) {
            Py_DECREF(seq);
            PyErr_SetString(PyExc_TypeError, "pack_frames expects bytes items");
            return NULL;
        }
        Py_ssize_t n = PyBytes_GET_SIZE(item);
        if (n > (Py_ssize_t)UINT32_MAX) {
            Py_DECREF(seq);
            PyErr_SetString(PyExc_ValueError, "frame too large");
            return NULL;
        }
        total += 4 + n;
    }
    PyObject *out = PyBytes_FromStringAndSize(NULL, total);
    if (out == NULL) {
        Py_DECREF(seq);
        return NULL;
    }
    unsigned char *dst = (unsigned char *)PyBytes_AS_STRING(out);
    for (Py_ssize_t i = 0; i < count; i++) {
        PyObject *item = PySequence_Fast_GET_ITEM(seq, i);
        Py_ssize_t n = PyBytes_GET_SIZE(item);
        write_be32(dst, (uint32_t)n);
        memcpy(dst + 4, PyBytes_AS_STRING(item), (size_t)n);
        dst += 4 + n;
    }
    Py_DECREF(seq);
    return out;
}

static PyMethodDef Methods[] = {
    {"drain_frames", drain_frames, METH_VARARGS,
     "drain_frames(buffer, offset, max_frame) -> (list[bytes], consumed)"},
    {"pack_frames", pack_frames, METH_VARARGS,
     "pack_frames(bodies) -> bytes"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_framing",
    "C fast path for telemetry frame packing/draining", -1, Methods,
};

PyMODINIT_FUNC PyInit__framing(void) { return PyModule_Create(&module); }
