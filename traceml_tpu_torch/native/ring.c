/* Lock-free SPSC ring operations over a shared memory-mapped buffer.
 *
 * Layout (all integers little-endian, header is 64 bytes):
 *
 *   off  size  field
 *     0     4  magic "TMR1"
 *     4     4  version (1)
 *     8     8  capacity          data-region bytes (buffer len - 64)
 *    16     8  head              producer-owned: total bytes published
 *    24     8  tail              consumer-owned: total bytes consumed
 *    32     8  producer_gen      stamped by the producer at create
 *    40     8  consumer_gen      stamped by the consumer at attach
 *    48     4  producer_pid
 *    52    12  reserved
 *    64     -  data region: u32-le length-prefixed frames, bytes wrap
 *              modulo capacity (a frame may straddle the wrap point)
 *
 * Single-producer (one rank's client thread), single-consumer (the
 * aggregator's selector tick).  Commit protocol: the producer memcpys
 * the length prefix + body into free space, then publishes by storing
 * head with release order.  A consumer never sees a torn frame — bytes
 * beyond head are invisible, and kill -9 mid-write just leaves
 * unpublished garbage that the next append overwrites.
 *
 *   ring_append(buf, payload) -> 0 (full) | 1 (published)
 *   ring_drain(buf, max_frames) -> list[bytes]     (advances tail)
 *   ring_peek(buf, cursor, max_frames) -> (list[bytes], new_cursor)
 *                                         (tail untouched)
 *   ring_set_tail(buf, value) -> None              (commit point)
 *   ring_readable(buf) -> int                      (bytes pending)
 *
 * Durable consumption is two-phase: the aggregator peeks frames from
 * an in-memory cursor and only stores tail (ring_set_tail) once the
 * envelopes are group-committed to sqlite.  A consumer crash between
 * peek and commit re-delivers the window to its successor, and the
 * writer's seq dedup drops the overlap — the ring is a replay buffer,
 * not just a queue.
 *
 * The Python mirror lives in transport/shm_ring.py; both sides of a
 * ring may independently be native or pure-Python — the layout is the
 * contract, not the code.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

#define RING_HDR 64
#define OFF_CAPACITY 8
#define OFF_HEAD 16
#define OFF_TAIL 24

static int check_buf(Py_buffer *view, uint64_t *capacity) {
    if (view->len < RING_HDR + 8) {
        PyErr_SetString(PyExc_ValueError, "ring buffer too small");
        return -1;
    }
    const unsigned char *p = (const unsigned char *)view->buf;
    if (memcmp(p, "TMR1", 4) != 0) {
        PyErr_SetString(PyExc_ValueError, "bad ring magic");
        return -1;
    }
    memcpy(capacity, p + OFF_CAPACITY, 8);
    if (*capacity == 0 || (Py_ssize_t)(*capacity + RING_HDR) > view->len) {
        PyErr_SetString(PyExc_ValueError, "ring capacity out of range");
        return -1;
    }
    return 0;
}

static inline uint64_t load_acquire_u64(const void *p) {
    uint64_t v;
    __atomic_load((const uint64_t *)p, &v, __ATOMIC_ACQUIRE);
    return v;
}

static inline void store_release_u64(void *p, uint64_t v) {
    __atomic_store((uint64_t *)p, &v, __ATOMIC_RELEASE);
}

/* copy n bytes into the data region at logical position pos (wraps) */
static void ring_write(unsigned char *data, uint64_t capacity, uint64_t pos,
                       const unsigned char *src, uint64_t n) {
    uint64_t at = pos % capacity;
    uint64_t first = capacity - at;
    if (first > n) first = n;
    memcpy(data + at, src, first);
    if (n > first) memcpy(data, src + first, n - first);
}

static void ring_read(const unsigned char *data, uint64_t capacity,
                      uint64_t pos, unsigned char *dst, uint64_t n) {
    uint64_t at = pos % capacity;
    uint64_t first = capacity - at;
    if (first > n) first = n;
    memcpy(dst, data + at, first);
    if (n > first) memcpy(dst + first, data, n - first);
}

static PyObject *ring_append(PyObject *self, PyObject *args) {
    Py_buffer view, payload;
    if (!PyArg_ParseTuple(args, "w*y*", &view, &payload)) {
        return NULL;
    }
    uint64_t capacity;
    if (check_buf(&view, &capacity) < 0) {
        PyBuffer_Release(&payload);
        PyBuffer_Release(&view);
        return NULL;
    }
    unsigned char *base = (unsigned char *)view.buf;
    uint64_t need = 4 + (uint64_t)payload.len;
    if (need > capacity) {
        PyBuffer_Release(&payload);
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "frame larger than ring");
        return NULL;
    }
    uint64_t head = load_acquire_u64(base + OFF_HEAD);
    uint64_t tail = load_acquire_u64(base + OFF_TAIL);
    if (head - tail + need > capacity) {
        PyBuffer_Release(&payload);
        PyBuffer_Release(&view);
        return PyLong_FromLong(0); /* full */
    }
    unsigned char prefix[4];
    uint32_t n32 = (uint32_t)payload.len;
    prefix[0] = (unsigned char)n32;
    prefix[1] = (unsigned char)(n32 >> 8);
    prefix[2] = (unsigned char)(n32 >> 16);
    prefix[3] = (unsigned char)(n32 >> 24);
    unsigned char *data = base + RING_HDR;
    ring_write(data, capacity, head, prefix, 4);
    ring_write(data, capacity, head + 4,
               (const unsigned char *)payload.buf, (uint64_t)payload.len);
    store_release_u64(base + OFF_HEAD, head + need);
    PyBuffer_Release(&payload);
    PyBuffer_Release(&view);
    return PyLong_FromLong(1);
}

static PyObject *ring_drain(PyObject *self, PyObject *args) {
    Py_buffer view;
    Py_ssize_t max_frames;
    if (!PyArg_ParseTuple(args, "w*n", &view, &max_frames)) {
        return NULL;
    }
    uint64_t capacity;
    if (check_buf(&view, &capacity) < 0) {
        PyBuffer_Release(&view);
        return NULL;
    }
    unsigned char *base = (unsigned char *)view.buf;
    const unsigned char *data = base + RING_HDR;
    PyObject *frames = PyList_New(0);
    if (frames == NULL) {
        PyBuffer_Release(&view);
        return NULL;
    }
    uint64_t tail = load_acquire_u64(base + OFF_TAIL);
    uint64_t head = load_acquire_u64(base + OFF_HEAD);
    Py_ssize_t emitted = 0;
    while ((max_frames <= 0 || emitted < max_frames) && head - tail >= 4) {
        unsigned char prefix[4];
        ring_read(data, capacity, tail, prefix, 4);
        uint32_t n = (uint32_t)prefix[0] | ((uint32_t)prefix[1] << 8) |
                     ((uint32_t)prefix[2] << 16) | ((uint32_t)prefix[3] << 24);
        if ((uint64_t)n + 4 > capacity || head - tail < 4 + (uint64_t)n) {
            /* corrupt length or incomplete publish (cannot happen with a
             * well-behaved producer): surface as ValueError so the
             * consumer quarantines the ring */
            if ((uint64_t)n + 4 > capacity) {
                Py_DECREF(frames);
                PyBuffer_Release(&view);
                PyErr_Format(PyExc_ValueError,
                             "ring frame length %u exceeds capacity", n);
                return NULL;
            }
            break;
        }
        PyObject *frame = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)n);
        if (frame == NULL) {
            Py_DECREF(frames);
            PyBuffer_Release(&view);
            return NULL;
        }
        ring_read(data, capacity, tail + 4,
                  (unsigned char *)PyBytes_AS_STRING(frame), n);
        if (PyList_Append(frames, frame) < 0) {
            Py_DECREF(frame);
            Py_DECREF(frames);
            PyBuffer_Release(&view);
            return NULL;
        }
        Py_DECREF(frame);
        tail += 4 + (uint64_t)n;
        emitted++;
        store_release_u64(base + OFF_TAIL, tail);
    }
    PyBuffer_Release(&view);
    return frames;
}

static PyObject *ring_peek(PyObject *self, PyObject *args) {
    Py_buffer view;
    unsigned long long cursor_in;
    Py_ssize_t max_frames;
    if (!PyArg_ParseTuple(args, "w*Kn", &view, &cursor_in, &max_frames)) {
        return NULL;
    }
    uint64_t capacity;
    if (check_buf(&view, &capacity) < 0) {
        PyBuffer_Release(&view);
        return NULL;
    }
    unsigned char *base = (unsigned char *)view.buf;
    const unsigned char *data = base + RING_HDR;
    uint64_t cursor = (uint64_t)cursor_in;
    uint64_t head = load_acquire_u64(base + OFF_HEAD);
    if (cursor > head) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "ring cursor beyond head");
        return NULL;
    }
    PyObject *frames = PyList_New(0);
    if (frames == NULL) {
        PyBuffer_Release(&view);
        return NULL;
    }
    Py_ssize_t emitted = 0;
    while ((max_frames <= 0 || emitted < max_frames) && head - cursor >= 4) {
        unsigned char prefix[4];
        ring_read(data, capacity, cursor, prefix, 4);
        uint32_t n = (uint32_t)prefix[0] | ((uint32_t)prefix[1] << 8) |
                     ((uint32_t)prefix[2] << 16) | ((uint32_t)prefix[3] << 24);
        if ((uint64_t)n + 4 > capacity) {
            Py_DECREF(frames);
            PyBuffer_Release(&view);
            PyErr_Format(PyExc_ValueError,
                         "ring frame length %u exceeds capacity", n);
            return NULL;
        }
        if (head - cursor < 4 + (uint64_t)n) break; /* mid-publish */
        PyObject *frame = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)n);
        if (frame == NULL) {
            Py_DECREF(frames);
            PyBuffer_Release(&view);
            return NULL;
        }
        ring_read(data, capacity, cursor + 4,
                  (unsigned char *)PyBytes_AS_STRING(frame), n);
        if (PyList_Append(frames, frame) < 0) {
            Py_DECREF(frame);
            Py_DECREF(frames);
            PyBuffer_Release(&view);
            return NULL;
        }
        Py_DECREF(frame);
        cursor += 4 + (uint64_t)n;
        emitted++;
    }
    PyBuffer_Release(&view);
    PyObject *cur = PyLong_FromUnsignedLongLong(cursor);
    if (cur == NULL) {
        Py_DECREF(frames);
        return NULL;
    }
    PyObject *out = PyTuple_Pack(2, frames, cur);
    Py_DECREF(frames);
    Py_DECREF(cur);
    return out;
}

static PyObject *ring_set_tail(PyObject *self, PyObject *args) {
    Py_buffer view;
    unsigned long long value;
    if (!PyArg_ParseTuple(args, "w*K", &view, &value)) {
        return NULL;
    }
    uint64_t capacity;
    if (check_buf(&view, &capacity) < 0) {
        PyBuffer_Release(&view);
        return NULL;
    }
    unsigned char *base = (unsigned char *)view.buf;
    store_release_u64(base + OFF_TAIL, (uint64_t)value);
    PyBuffer_Release(&view);
    Py_RETURN_NONE;
}

static PyObject *ring_readable(PyObject *self, PyObject *args) {
    Py_buffer view;
    if (!PyArg_ParseTuple(args, "y*", &view)) {
        return NULL;
    }
    uint64_t capacity;
    if (check_buf(&view, &capacity) < 0) {
        PyBuffer_Release(&view);
        return NULL;
    }
    const unsigned char *base = (const unsigned char *)view.buf;
    uint64_t head = load_acquire_u64(base + OFF_HEAD);
    uint64_t tail = load_acquire_u64(base + OFF_TAIL);
    PyBuffer_Release(&view);
    return PyLong_FromUnsignedLongLong(head - tail);
}

static PyMethodDef Methods[] = {
    {"ring_append", ring_append, METH_VARARGS,
     "ring_append(buf, payload) -> 0 if full else 1"},
    {"ring_drain", ring_drain, METH_VARARGS,
     "ring_drain(buf, max_frames) -> list[bytes]"},
    {"ring_peek", ring_peek, METH_VARARGS,
     "ring_peek(buf, cursor, max_frames) -> (list[bytes], new_cursor)"},
    {"ring_set_tail", ring_set_tail, METH_VARARGS,
     "ring_set_tail(buf, value) -> None (the durable-commit point)"},
    {"ring_readable", ring_readable, METH_VARARGS,
     "ring_readable(buf) -> pending byte count"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_ring",
    "C fast path for the SPSC shared-memory telemetry ring", -1, Methods,
};

PyMODINIT_FUNC PyInit__ring(void) { return PyModule_Create(&module); }
