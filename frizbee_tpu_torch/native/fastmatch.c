/* fastmatch: C extension Match type + bulk construction.
 *
 * The reference's match_iter yields Copy structs at register speed
 * (reference: src/matcher/iter.rs:19-141); CPython's floor for an
 * equivalent is object construction, and a slotted dataclass pays the
 * interpreter's call and attribute protocol per instance. This extension
 * type constructs without it and `build_matches` amortizes the loop in C,
 * so iterator and list consumers run at the platform's real floor.
 *
 * Semantics contract: frizbee_tpu_torch/types.py's dataclass Match (kept
 * as PY_MATCH, the behavioral oracle — tests/test_torch_native.py pins
 * construction, mutation, equality, ordering, repr, serde and pickling
 * against it).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>

typedef struct {
    PyObject_HEAD
    long long score;
    long long index;
    char exact;
    long long end_col;
} MatchObject;

static PyTypeObject Match_Type;

static PyObject *
Match_new(PyTypeObject *type, PyObject *args, PyObject *kwds)
{
    static char *kwlist[] = {"score", "index", "exact", "end_col", NULL};
    long long score = 0, index = 0, end_col = 0;
    int exact = 0;
    if (!PyArg_ParseTupleAndKeywords(args, kwds, "|LLpL", kwlist,
                                     &score, &index, &exact, &end_col))
        return NULL;
    MatchObject *self = (MatchObject *)type->tp_alloc(type, 0);
    if (self == NULL)
        return NULL;
    self->score = score;
    self->index = index;
    self->exact = (char)exact;
    self->end_col = end_col;
    return (PyObject *)self;
}

static PyMemberDef Match_members[] = {
    {"score", T_LONGLONG, offsetof(MatchObject, score), 0, NULL},
    {"index", T_LONGLONG, offsetof(MatchObject, index), 0, NULL},
    {"end_col", T_LONGLONG, offsetof(MatchObject, end_col), 0, NULL},
    {NULL}
};

/* exact as a getset (not T_BOOL): the dataclass accepts any truthy
 * assignment (numpy bool_, 0/1) and so must this type. */
static PyObject *
Match_get_exact(MatchObject *self, void *Py_UNUSED(closure))
{
    if (self->exact)
        Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

static int
Match_set_exact(MatchObject *self, PyObject *value,
                void *Py_UNUSED(closure))
{
    if (value == NULL) {
        PyErr_SetString(PyExc_AttributeError, "cannot delete exact");
        return -1;
    }
    int t = PyObject_IsTrue(value);
    if (t < 0)
        return -1;
    self->exact = (char)t;
    return 0;
}

static PyGetSetDef Match_getset[] = {
    {"exact", (getter)Match_get_exact, (setter)Match_set_exact, NULL,
     NULL},
    {NULL}
};

static PyObject *
Match_repr(MatchObject *self)
{
    return PyUnicode_FromFormat(
        "Match(score=%lld, index=%lld, exact=%s, end_col=%lld)",
        self->score, self->index, self->exact ? "True" : "False",
        self->end_col);
}

static PyObject *
Match_richcompare(PyObject *a, PyObject *b, int op)
{
    int a_is = PyObject_TypeCheck(a, &Match_Type);
    int b_is = PyObject_TypeCheck(b, &Match_Type);
    if (!a_is || !b_is)
        Py_RETURN_NOTIMPLEMENTED;
    MatchObject *x = (MatchObject *)a, *y = (MatchObject *)b;
    if (op == Py_EQ || op == Py_NE) {
        int eq = (x->score == y->score && x->index == y->index &&
                  (!!x->exact) == (!!y->exact) &&
                  x->end_col == y->end_col);
        if (op == Py_NE)
            eq = !eq;
        if (eq)
            Py_RETURN_TRUE;
        Py_RETURN_FALSE;
    }
    /* ordering: (-score, index), the dataclass sort_key contract */
    long long ka0 = -x->score, kb0 = -y->score;
    int lt = (ka0 < kb0) || (ka0 == kb0 && x->index < y->index);
    int eqk = (ka0 == kb0 && x->index == y->index);
    int r;
    switch (op) {
    case Py_LT: r = lt; break;
    case Py_LE: r = lt || eqk; break;
    case Py_GT: r = !lt && !eqk; break;
    case Py_GE: r = !lt; break;
    default: Py_RETURN_NOTIMPLEMENTED;
    }
    if (r)
        Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

static PyObject *
Match_sort_key(MatchObject *self, PyObject *Py_UNUSED(ignored))
{
    return Py_BuildValue("(LL)", -self->score, self->index);
}

static PyObject *
Match_to_dict(MatchObject *self, PyObject *Py_UNUSED(ignored))
{
    return Py_BuildValue("{s:L,s:L,s:O,s:L}",
                         "score", self->score, "index", self->index,
                         "exact", self->exact ? Py_True : Py_False,
                         "end_col", self->end_col);
}

/* int(x)-equivalent coercion: the dataclass from_dict truncates floats
 * via int(); PyLong_AsLongLong alone would reject them. */
static long long
as_longlong_coerce(PyObject *v, int *err)
{
    PyObject *num = PyNumber_Long(v);
    if (num == NULL) {
        *err = 1;
        return 0;
    }
    long long out = PyLong_AsLongLong(num);
    Py_DECREF(num);
    if (PyErr_Occurred())
        *err = 1;
    return out;
}

static PyObject *
Match_from_dict(PyObject *cls, PyObject *d)
{
    PyObject *score = PyDict_GetItemString(d, "score");
    PyObject *index = PyDict_GetItemString(d, "index");
    PyObject *exact = PyDict_GetItemString(d, "exact");
    PyObject *end_col = PyDict_GetItemString(d, "end_col");
    if (score == NULL || index == NULL) {
        PyErr_SetString(PyExc_KeyError, "score/index required");
        return NULL;
    }
    MatchObject *m =
        (MatchObject *)((PyTypeObject *)cls)->tp_alloc((PyTypeObject *)cls,
                                                       0);
    if (m == NULL)
        return NULL;
    int err = 0;
    m->score = as_longlong_coerce(score, &err);
    m->index = as_longlong_coerce(index, &err);
    int ex = exact ? PyObject_IsTrue(exact) : 0;
    if (ex < 0)
        err = 1;
    m->exact = (char)(ex > 0);
    m->end_col = end_col ? as_longlong_coerce(end_col, &err) : 0;
    if (err || PyErr_Occurred()) {
        Py_DECREF(m);
        return NULL;
    }
    return (PyObject *)m;
}

/* pickle/copy support: the dataclass round-trips through pickle and
 * copy.deepcopy; __reduce__ keeps that. Pickles reference
 * frizbee_tpu_torch.types._rebuild_match — a stable, always-importable
 * factory — NOT this synthetic extension module, so unpickling builds
 * whatever Match that module binds. */
static PyObject *
Match_reduce(MatchObject *self, PyObject *Py_UNUSED(ignored))
{
    PyObject *types_mod = PyImport_ImportModule("frizbee_tpu_torch.types");
    if (types_mod == NULL)
        return NULL;
    PyObject *factory =
        PyObject_GetAttrString(types_mod, "_rebuild_match");
    Py_DECREF(types_mod);
    if (factory == NULL)
        return NULL;
    PyObject *out = Py_BuildValue(
        "(N(LLOL))", factory, self->score, self->index,
        self->exact ? Py_True : Py_False, self->end_col);
    return out;
}

static PyObject *
Match_from_index(PyObject *cls, PyObject *arg)
{
    MatchObject *m =
        (MatchObject *)((PyTypeObject *)cls)->tp_alloc((PyTypeObject *)cls,
                                                       0);
    if (m == NULL)
        return NULL;
    m->score = 0;
    m->index = PyLong_AsLongLong(arg);
    m->exact = 0;
    m->end_col = 0;
    if (PyErr_Occurred()) {
        Py_DECREF(m);
        return NULL;
    }
    return (PyObject *)m;
}

static PyMethodDef Match_methods[] = {
    {"__reduce__", (PyCFunction)Match_reduce, METH_NOARGS, NULL},
    {"sort_key", (PyCFunction)Match_sort_key, METH_NOARGS, NULL},
    {"to_dict", (PyCFunction)Match_to_dict, METH_NOARGS, NULL},
    {"from_dict", (PyCFunction)Match_from_dict, METH_O | METH_CLASS, NULL},
    {"from_index", (PyCFunction)Match_from_index, METH_O | METH_CLASS,
     NULL},
    {NULL}
};

static PyTypeObject Match_Type = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "frizbee_tpu_torch.native.fastmatch.Match",
    .tp_basicsize = sizeof(MatchObject),
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_BASETYPE,
    .tp_new = Match_new,
    .tp_repr = (reprfunc)Match_repr,
    .tp_richcompare = Match_richcompare,
    .tp_members = Match_members,
    .tp_getset = Match_getset,
    .tp_methods = Match_methods,
};

/* build_matches(index, score, exact, end_col) -> list[Match]
 *
 * Arrays arrive as contiguous buffers: index/score/end_col int64,
 * exact uint8/bool. One C loop allocates and fills every object. */
static PyObject *
build_matches(PyObject *Py_UNUSED(mod), PyObject *args)
{
    Py_buffer bi, bs, be, bc;
    if (!PyArg_ParseTuple(args, "y*y*y*y*", &bi, &bs, &be, &bc))
        return NULL;
    Py_ssize_t n = bi.len / (Py_ssize_t)sizeof(long long);
    PyObject *out = NULL;
    if (bs.len != bi.len || bc.len != bi.len ||
        be.len != n) {
        PyErr_SetString(PyExc_ValueError,
                        "build_matches: column length mismatch "
                        "(index/score/end_col int64, exact uint8)");
        goto done;
    }
    const long long *idx = (const long long *)bi.buf;
    const long long *sc = (const long long *)bs.buf;
    const unsigned char *ex = (const unsigned char *)be.buf;
    const long long *ec = (const long long *)bc.buf;
    out = PyList_New(n);
    if (out == NULL)
        goto done;
    for (Py_ssize_t i = 0; i < n; i++) {
        MatchObject *m =
            (MatchObject *)Match_Type.tp_alloc(&Match_Type, 0);
        if (m == NULL) {
            Py_DECREF(out);
            out = NULL;
            goto done;
        }
        m->score = sc[i];
        m->index = idx[i];
        m->exact = (char)(ex[i] != 0);
        m->end_col = ec[i];
        PyList_SET_ITEM(out, i, (PyObject *)m);
    }
done:
    PyBuffer_Release(&bi);
    PyBuffer_Release(&bs);
    PyBuffer_Release(&be);
    PyBuffer_Release(&bc);
    return out;
}

static PyMethodDef module_methods[] = {
    {"build_matches", build_matches, METH_VARARGS,
     "build_matches(index_i64, score_i64, exact_u8, end_col_i64) -> "
     "list[Match]"},
    {NULL}
};

static struct PyModuleDef fastmatch_module = {
    PyModuleDef_HEAD_INIT, "fastmatch",
    "C Match type + bulk construction", -1, module_methods,
};

PyMODINIT_FUNC
PyInit_fastmatch(void)
{
    if (PyType_Ready(&Match_Type) < 0)
        return NULL;
    PyObject *m = PyModule_Create(&fastmatch_module);
    if (m == NULL)
        return NULL;
    Py_INCREF(&Match_Type);
    if (PyModule_AddObject(m, "Match", (PyObject *)&Match_Type) < 0) {
        Py_DECREF(&Match_Type);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
