/* fasttrans — native per-operation transition engine for the
 * preempt/reclaim/backfill hot paths.
 *
 * The bulk-apply writeback (fastapply.c) nativized the allocate action's
 * whole-session commit; what remained interpreted was the PER-OPERATION
 * Statement machinery the preempt/reclaim actions execute thousands of
 * times per session (reference pkg/scheduler/framework/statement.go:29-156,
 * session.go:198-369): a task status flip is a job status-index bucket
 * move + allocated-resource boundary accounting + a node-accounting
 * transition + the DRF/proportion share event handlers — ~15 interpreted
 * calls, each microseconds, summing to hundreds of milliseconds at the
 * overcommit benchmark scale.
 *
 * This module executes one whole transition per C call, with semantics
 * IDENTICAL to the Python methods it shadows (JobInfo.update_task_status,
 * NodeInfo.update_task/add_task/remove_task, drf/proportion event
 * handlers). The Python implementations remain the behavioral oracle and
 * the fallback: a TransCtx is only built when the session's event-handler
 * set is exactly the recognized stock set (ops/fasttrans.py), and any
 * sub-case the fused paths do not model is delegated back to the original
 * Python method mid-operation (never skipped).
 *
 * The predicates plugin's resident-affinity tracker stays in Python and is
 * invoked by the wrapper (ops/fasttrans.py) after each C call, in the same
 * relative order the session would fire it; its deallocate arm is a
 * statically-verifiable no-op for RELEASING tasks (predicates.py
 * _track_deallocate guards both branches on status != RELEASING), which is
 * the one case this module skips it.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <math.h>

/* epsilon constants — volcano_tpu_torch/api/resource.py MIN_*
 * (resource_info.go:70-72) */
#define MIN_MILLI_CPU 10.0
#define MIN_MILLI_SCALAR 10.0
#define MIN_MEMORY (10.0 * 1024.0 * 1024.0)

static PyObject *s_milli_cpu, *s_memory, *s_scalar_resources, *s_status,
    *s_uid, *s_job, *s_queue, *s_node_name, *s_tasks, *s_task_status_index,
    *s_status_version, *s_allocated, *s_resreq, *s_init_resreq, *s_pod,
    *s_metadata, *s_namespace, *s_name, *s_acct_gen, *s_idle, *s_used,
    *s_releasing, *s_node, *s_state, *s_update_task_status, *s_update_task,
    *s_shared_clone, *s_priority, *s_volume_ready, *s_row, *s_row_gen,
    *s_key, *s_share, *s_dominant_resource, *s_deserved, *s_error,
    *s_pending_sum;

static int
intern_all(void)
{
#define I(var, str) if (!(var = PyUnicode_InternFromString(str))) return -1;
    I(s_milli_cpu, "milli_cpu") I(s_memory, "memory")
    I(s_scalar_resources, "scalar_resources") I(s_status, "status")
    I(s_uid, "uid") I(s_job, "job") I(s_queue, "queue")
    I(s_node_name, "node_name") I(s_tasks, "tasks")
    I(s_task_status_index, "task_status_index")
    I(s_status_version, "_status_version") I(s_allocated, "allocated")
    I(s_resreq, "resreq") I(s_init_resreq, "init_resreq") I(s_pod, "pod")
    I(s_metadata, "metadata") I(s_namespace, "namespace") I(s_name, "name")
    I(s_acct_gen, "_acct_gen") I(s_idle, "idle") I(s_used, "used")
    I(s_releasing, "releasing") I(s_node, "node") I(s_state, "state")
    I(s_update_task_status, "update_task_status")
    I(s_update_task, "update_task") I(s_shared_clone, "shared_clone")
    I(s_priority, "priority") I(s_volume_ready, "volume_ready")
    I(s_row, "row") I(s_row_gen, "row_gen") I(s_key, "key")
    I(s_share, "share") I(s_dominant_resource, "dominant_resource")
    I(s_deserved, "deserved") I(s_error, "error")
    I(s_pending_sum, "pending_sum")
#undef I
    return 0;
}

/* ------------------------------------------------------------------ */
/* small object helpers                                               */
/* ------------------------------------------------------------------ */

static int
get_f64(PyObject *obj, PyObject *attr, double *out)
{
    PyObject *v = PyObject_GetAttr(obj, attr);
    if (v == NULL)
        return -1;
    *out = PyFloat_AsDouble(v);
    Py_DECREF(v);
    if (*out == -1.0 && PyErr_Occurred())
        return -1;
    return 0;
}

static int
set_f64(PyObject *obj, PyObject *attr, double val)
{
    PyObject *v = PyFloat_FromDouble(val);
    if (v == NULL)
        return -1;
    int rc = PyObject_SetAttr(obj, attr, v);
    Py_DECREF(v);
    return rc;
}

static int
bump_int_attr(PyObject *obj, PyObject *name)
{
    PyObject *v = PyObject_GetAttr(obj, name);
    if (v == NULL)
        return -1;
    long long x = PyLong_AsLongLong(v);
    Py_DECREF(v);
    if (x == -1 && PyErr_Occurred())
        return -1;
    PyObject *nv = PyLong_FromLongLong(x + 1);
    if (nv == NULL)
        return -1;
    int rc = PyObject_SetAttr(obj, name, nv);
    Py_DECREF(nv);
    return rc;
}

/* dict-or-raise lookup helper: returns BORROWED ref or NULL (sets
 * KeyError only when raise_missing). */
static PyObject *
dict_get(PyObject *d, PyObject *key, int raise_missing)
{
    PyObject *v = PyDict_GetItemWithError(d, key);
    if (v == NULL && !PyErr_Occurred() && raise_missing)
        PyErr_SetObject(PyExc_KeyError, key);
    return v;
}

/* ------------------------------------------------------------------ */
/* Resource arithmetic twins (volcano_tpu_torch/api/resource.py)      */
/* ------------------------------------------------------------------ */

/* rr.less_equal(self-style): le(l, r) with per-dimension epsilons —
 * exact mirror of Resource.less_equal(l=self_res, r=rr). Returns 1/0,
 * -1 on error. */
static int
res_less_equal(PyObject *l, PyObject *r)
{
    double lc, lm, rc_, rm;
    if (get_f64(l, s_milli_cpu, &lc) < 0 || get_f64(l, s_memory, &lm) < 0 ||
        get_f64(r, s_milli_cpu, &rc_) < 0 || get_f64(r, s_memory, &rm) < 0)
        return -1;
    if (!(lc < rc_ || fabs(lc - rc_) < MIN_MILLI_CPU))
        return 0;
    if (!(lm < rm || fabs(lm - rm) < MIN_MEMORY))
        return 0;
    PyObject *ls = PyObject_GetAttr(l, s_scalar_resources);
    if (ls == NULL)
        return -1;
    if (ls == Py_None) {
        Py_DECREF(ls);
        return 1;
    }
    PyObject *rs = PyObject_GetAttr(r, s_scalar_resources);
    if (rs == NULL) {
        Py_DECREF(ls);
        return -1;
    }
    int result = 1;
    PyObject *name, *quant;
    Py_ssize_t pos = 0;
    while (PyDict_Next(ls, &pos, &name, &quant)) {
        double q = PyFloat_AsDouble(quant);
        if (q == -1.0 && PyErr_Occurred()) {
            result = -1;
            break;
        }
        if (q <= MIN_MILLI_SCALAR)
            continue;
        if (rs == Py_None) {
            result = 0;
            break;
        }
        PyObject *rq = PyDict_GetItemWithError(rs, name);
        if (rq == NULL && PyErr_Occurred()) {
            result = -1;
            break;
        }
        double rv = 0.0;
        if (rq != NULL) {
            rv = PyFloat_AsDouble(rq);
            if (rv == -1.0 && PyErr_Occurred()) {
                result = -1;
                break;
            }
        }
        if (!(q < rv || fabs(q - rv) < MIN_MILLI_SCALAR)) {
            result = 0;
            break;
        }
    }
    Py_DECREF(ls);
    Py_DECREF(rs);
    return result;
}

/* res.add(rr) — exact mirror of Resource.add (mutating). */
static int
res_add(PyObject *res, PyObject *rr)
{
    double a, b;
    if (get_f64(res, s_milli_cpu, &a) < 0 || get_f64(rr, s_milli_cpu, &b) < 0)
        return -1;
    if (set_f64(res, s_milli_cpu, a + b) < 0)
        return -1;
    if (get_f64(res, s_memory, &a) < 0 || get_f64(rr, s_memory, &b) < 0)
        return -1;
    if (set_f64(res, s_memory, a + b) < 0)
        return -1;
    PyObject *rs = PyObject_GetAttr(rr, s_scalar_resources);
    if (rs == NULL)
        return -1;
    if (rs == Py_None) {
        Py_DECREF(rs);
        return 0;
    }
    PyObject *ss = PyObject_GetAttr(res, s_scalar_resources);
    if (ss == NULL) {
        Py_DECREF(rs);
        return -1;
    }
    if (ss == Py_None && PyDict_Size(rs) > 0) {
        Py_DECREF(ss);
        ss = PyDict_New();
        if (ss == NULL || PyObject_SetAttr(res, s_scalar_resources, ss) < 0) {
            Py_XDECREF(ss);
            Py_DECREF(rs);
            return -1;
        }
    }
    int rc = 0;
    if (ss != Py_None) {
        PyObject *name, *quant;
        Py_ssize_t pos = 0;
        while (PyDict_Next(rs, &pos, &name, &quant)) {
            PyObject *cur = PyDict_GetItemWithError(ss, name);
            if (cur == NULL && PyErr_Occurred()) {
                rc = -1;
                break;
            }
            double c = cur ? PyFloat_AsDouble(cur) : 0.0;
            double q = PyFloat_AsDouble(quant);
            if (PyErr_Occurred()) {
                rc = -1;
                break;
            }
            PyObject *nv = PyFloat_FromDouble(c + q);
            if (nv == NULL || PyDict_SetItem(ss, name, nv) < 0) {
                Py_XDECREF(nv);
                rc = -1;
                break;
            }
            Py_DECREF(nv);
        }
    }
    Py_DECREF(rs);
    Py_DECREF(ss);
    return rc;
}

/* res.sub(rr) — mirror of Resource.sub including the assertf sufficiency
 * check (assert_cb is volcano_tpu_torch.utils.assertions.assertf; it logs or
 * raises per the env gate, exactly as the Python path does). */
static int
res_sub(PyObject *res, PyObject *rr, PyObject *assert_cb)
{
    int le = res_less_equal(rr, res);
    if (le < 0)
        return -1;
    if (!le) {
        PyObject *sr = PyObject_Str(res);
        PyObject *srr = sr ? PyObject_Str(rr) : NULL;
        PyObject *text = srr ? PyUnicode_FromFormat(
            "resource is not sufficient to do operation: <%U> sub <%U>",
            sr, srr) : NULL;
        Py_XDECREF(sr);
        Py_XDECREF(srr);
        if (text == NULL)
            return -1;
        PyObject *r = PyObject_CallFunctionObjArgs(assert_cb, Py_False,
                                                   text, NULL);
        Py_DECREF(text);
        if (r == NULL)
            return -1;   /* panic mode: AssertionViolation propagates */
        Py_DECREF(r);
    }
    double a, b;
    if (get_f64(res, s_milli_cpu, &a) < 0 || get_f64(rr, s_milli_cpu, &b) < 0)
        return -1;
    if (set_f64(res, s_milli_cpu, a - b) < 0)
        return -1;
    if (get_f64(res, s_memory, &a) < 0 || get_f64(rr, s_memory, &b) < 0)
        return -1;
    if (set_f64(res, s_memory, a - b) < 0)
        return -1;
    PyObject *ss = PyObject_GetAttr(res, s_scalar_resources);
    if (ss == NULL)
        return -1;
    if (ss == Py_None) {
        Py_DECREF(ss);
        return 0;
    }
    PyObject *rs = PyObject_GetAttr(rr, s_scalar_resources);
    if (rs == NULL) {
        Py_DECREF(ss);
        return -1;
    }
    int rc = 0;
    if (rs != Py_None) {
        PyObject *name, *quant;
        Py_ssize_t pos = 0;
        while (PyDict_Next(rs, &pos, &name, &quant)) {
            PyObject *cur = PyDict_GetItemWithError(ss, name);
            if (cur == NULL && PyErr_Occurred()) {
                rc = -1;
                break;
            }
            double c = cur ? PyFloat_AsDouble(cur) : 0.0;
            double q = PyFloat_AsDouble(quant);
            if (PyErr_Occurred()) {
                rc = -1;
                break;
            }
            PyObject *nv = PyFloat_FromDouble(c - q);
            if (nv == NULL || PyDict_SetItem(ss, name, nv) < 0) {
                Py_XDECREF(nv);
                rc = -1;
                break;
            }
            Py_DECREF(nv);
        }
    }
    Py_DECREF(rs);
    Py_DECREF(ss);
    return rc;
}

/* Resource.get(name) with name as a Python str — mirror including the
 * nil-map zero default. */
static int
res_get_named(PyObject *res, PyObject *name, double *out)
{
    if (PyUnicode_CompareWithASCIIString(name, "cpu") == 0)
        return get_f64(res, s_milli_cpu, out);
    if (PyUnicode_CompareWithASCIIString(name, "memory") == 0)
        return get_f64(res, s_memory, out);
    PyObject *ss = PyObject_GetAttr(res, s_scalar_resources);
    if (ss == NULL)
        return -1;
    *out = 0.0;
    if (ss != Py_None) {
        PyObject *v = PyDict_GetItemWithError(ss, name);
        if (v == NULL && PyErr_Occurred()) {
            Py_DECREF(ss);
            return -1;
        }
        if (v != NULL) {
            *out = PyFloat_AsDouble(v);
            if (*out == -1.0 && PyErr_Occurred()) {
                Py_DECREF(ss);
                return -1;
            }
        }
    }
    Py_DECREF(ss);
    return 0;
}

/* ------------------------------------------------------------------ */
/* TransCtx                                                           */
/* ------------------------------------------------------------------ */

typedef struct {
    PyObject_HEAD
    PyObject *jobs;          /* dict uid -> JobInfo */
    PyObject *nodes;         /* dict name -> NodeInfo */
    PyObject *drf_attrs;     /* dict uid -> drf._Attr, or None */
    PyObject *drf_pairs;     /* list[(name, total_value)] or None */
    PyObject *drf_ns_attrs;  /* dict namespace -> drf._Attr, or None */
    PyObject *prop_attrs;    /* dict queue_uid -> _QueueAttr, or None */
    PyObject *st_pending, *st_allocated, *st_pipelined, *st_releasing,
        *st_running, *st_binding;
    PyObject *assert_cb;     /* assertions.assertf */
    PyObject *nodestate_cls; /* NodeState */
    PyObject *phase_notready;/* NodePhase.NOT_READY */
    PyObject *logger;        /* logging.Logger for swallowed errors */
    long alloc_mask;         /* bitwise-or of allocated statuses */
} TransCtx;

static int
status_long(PyObject *st, long *out)
{
    *out = PyLong_AsLong(st);
    if (*out == -1 && PyErr_Occurred())
        return -1;
    return 0;
}

static void
TransCtx_dealloc(TransCtx *self)
{
    Py_XDECREF(self->jobs);
    Py_XDECREF(self->nodes);
    Py_XDECREF(self->drf_attrs);
    Py_XDECREF(self->drf_pairs);
    Py_XDECREF(self->drf_ns_attrs);
    Py_XDECREF(self->prop_attrs);
    Py_XDECREF(self->st_pending);
    Py_XDECREF(self->st_allocated);
    Py_XDECREF(self->st_pipelined);
    Py_XDECREF(self->st_releasing);
    Py_XDECREF(self->st_running);
    Py_XDECREF(self->st_binding);
    Py_XDECREF(self->assert_cb);
    Py_XDECREF(self->nodestate_cls);
    Py_XDECREF(self->phase_notready);
    Py_XDECREF(self->logger);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static int
TransCtx_init(TransCtx *self, PyObject *args, PyObject *kwds)
{
    PyObject *jobs, *nodes, *drf_attrs, *drf_pairs, *drf_ns_attrs,
        *prop_attrs;
    PyObject *pending, *allocated, *pipelined, *releasing, *running, *binding;
    PyObject *assert_cb, *nodestate_cls, *phase_notready, *logger;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOOOOOOOO", &jobs, &nodes,
                          &drf_attrs, &drf_pairs, &drf_ns_attrs, &prop_attrs,
                          &pending, &allocated, &pipelined, &releasing,
                          &running, &binding, &assert_cb, &nodestate_cls,
                          &phase_notready, &logger))
        return -1;
#define KEEP(field, val) Py_INCREF(val); self->field = val;
    KEEP(jobs, jobs) KEEP(nodes, nodes) KEEP(drf_attrs, drf_attrs)
    KEEP(drf_pairs, drf_pairs) KEEP(drf_ns_attrs, drf_ns_attrs)
    KEEP(prop_attrs, prop_attrs)
    KEEP(st_pending, pending) KEEP(st_allocated, allocated)
    KEEP(st_pipelined, pipelined) KEEP(st_releasing, releasing)
    KEEP(st_running, running) KEEP(st_binding, binding)
    KEEP(assert_cb, assert_cb) KEEP(nodestate_cls, nodestate_cls)
    KEEP(phase_notready, phase_notready) KEEP(logger, logger)
#undef KEEP
    long a, b2, r, al;
    if (status_long(allocated, &a) < 0 || status_long(binding, &b2) < 0 ||
        status_long(running, &r) < 0)
        return -1;
    /* BOUND is not passed (never produced by these transitions) but is
     * part of the allocated set; statuses are single-bit IntFlags with
     * BOUND = BINDING << 1 (api/types.py:17-26). */
    al = a | b2 | (b2 << 1) | r;
    self->alloc_mask = al;
    return 0;
}

/* allocated_status(st) twin (api/types.py:32-40) — statuses are
 * single-bit IntFlags, so membership in the allocated set is a mask test */
static int
status_is_allocated(TransCtx *ctx, PyObject *st)
{
    long v = PyLong_AsLong(st);
    if (v == -1 && PyErr_Occurred())
        return -1;
    return (v & ctx->alloc_mask) != 0;
}

/* ------------------------------------------------------------------ */
/* JobInfo.update_task_status fused twin                               */
/* ------------------------------------------------------------------ */

/* Mirrors JobInfo.update_task_status (api/job_info.py:244-279): the fused
 * present-task path in C; absent task or mismatched request delegates to
 * the Python method itself. */
static int
job_update_task_status(TransCtx *ctx, PyObject *job, PyObject *task,
                       PyObject *new_status)
{
    PyObject *tasks = PyObject_GetAttr(job, s_tasks);
    if (tasks == NULL)
        return -1;
    PyObject *uid = PyObject_GetAttr(task, s_uid);
    if (uid == NULL) {
        Py_DECREF(tasks);
        return -1;
    }
    PyObject *stored = PyDict_GetItemWithError(tasks, uid); /* borrowed */
    if (stored == NULL && PyErr_Occurred())
        goto fail;
    int delegate = 0;
    if (stored == NULL) {
        delegate = 1;
    } else {
        PyObject *sreq = PyObject_GetAttr(stored, s_resreq);
        PyObject *treq = sreq ? PyObject_GetAttr(task, s_resreq) : NULL;
        if (treq == NULL) {
            Py_XDECREF(sreq);
            goto fail;
        }
        if (sreq != treq) {
            int ne = PyObject_RichCompareBool(sreq, treq, Py_NE);
            if (ne < 0) {
                Py_DECREF(sreq);
                Py_DECREF(treq);
                goto fail;
            }
            delegate = ne;
        }
        Py_DECREF(sreq);
        Py_DECREF(treq);
    }
    if (delegate) {
        PyObject *r = PyObject_CallMethodObjArgs(
            job, s_update_task_status, task, new_status, NULL);
        Py_DECREF(tasks);
        Py_DECREF(uid);
        if (r == NULL)
            return -1;
        Py_DECREF(r);
        return 0;
    }

    PyObject *old_status = PyObject_GetAttr(stored, s_status);
    if (old_status == NULL)
        goto fail;
    int old_alloc = status_is_allocated(ctx, old_status);
    int new_alloc = old_alloc < 0 ? -1 : status_is_allocated(ctx, new_status);
    if (new_alloc < 0) {
        Py_DECREF(old_status);
        goto fail;
    }

    /* _delete_task_index(stored) */
    PyObject *index = PyObject_GetAttr(job, s_task_status_index);
    if (index == NULL) {
        Py_DECREF(old_status);
        goto fail;
    }
    PyObject *bucket = PyDict_GetItemWithError(index, old_status);
    if (bucket == NULL && PyErr_Occurred()) {
        Py_DECREF(old_status);
        Py_DECREF(index);
        goto fail;
    }
    if (bucket != NULL) {
        if (PyDict_DelItem(bucket, uid) < 0) {
            if (!PyErr_ExceptionMatches(PyExc_KeyError)) {
                Py_DECREF(old_status);
                Py_DECREF(index);
                goto fail;
            }
            PyErr_Clear();
        }
        if (PyDict_Size(bucket) == 0) {
            if (PyDict_DelItem(index, old_status) < 0) {
                Py_DECREF(old_status);
                Py_DECREF(index);
                goto fail;
            }
        }
    }
    if (bump_int_attr(job, s_status_version) < 0) {
        Py_DECREF(old_status);
        Py_DECREF(index);
        goto fail;
    }

    /* task.status = new_status */
    if (PyObject_SetAttr(task, s_status, new_status) < 0) {
        Py_DECREF(old_status);
        Py_DECREF(index);
        goto fail;
    }

    /* allocated boundary accounting */
    if (old_alloc != new_alloc) {
        PyObject *alloc_res = PyObject_GetAttr(job, s_allocated);
        PyObject *req = alloc_res ? PyObject_GetAttr(stored, s_resreq) : NULL;
        int rc;
        if (req == NULL) {
            Py_XDECREF(alloc_res);
            Py_DECREF(old_status);
            Py_DECREF(index);
            goto fail;
        }
        if (old_alloc)
            rc = res_sub(alloc_res, req, ctx->assert_cb);
        else
            rc = res_add(alloc_res, req);
        Py_DECREF(alloc_res);
        Py_DECREF(req);
        if (rc < 0) {
            Py_DECREF(old_status);
            Py_DECREF(index);
            goto fail;
        }
    }

    /* pending boundary accounting — the PENDING-bucket request sum kept
     * incrementally on JobInfo (job_info.py update_task_status's fused
     * path), mirrored here so native transitions keep it in sync */
    {
        int old_p = (old_status == ctx->st_pending) ? 1 :
            PyObject_RichCompareBool(old_status, ctx->st_pending, Py_EQ);
        int new_p = (old_p < 0) ? -1 :
            ((new_status == ctx->st_pending) ? 1 :
             PyObject_RichCompareBool(new_status, ctx->st_pending, Py_EQ));
        if (new_p < 0) {
            Py_DECREF(old_status);
            Py_DECREF(index);
            goto fail;
        }
        if (old_p != new_p) {
            PyObject *psum = PyObject_GetAttr(job, s_pending_sum);
            PyObject *req = psum ? PyObject_GetAttr(stored, s_resreq) : NULL;
            int rc;
            if (req == NULL) {
                Py_XDECREF(psum);
                Py_DECREF(old_status);
                Py_DECREF(index);
                goto fail;
            }
            if (old_p)
                rc = res_sub(psum, req, ctx->assert_cb);
            else
                rc = res_add(psum, req);
            Py_DECREF(psum);
            Py_DECREF(req);
            if (rc < 0) {
                Py_DECREF(old_status);
                Py_DECREF(index);
                goto fail;
            }
        }
    }
    Py_DECREF(old_status);

    /* self.tasks[uid] = task; _add_task_index(task) */
    if (PyDict_SetItem(tasks, uid, task) < 0) {
        Py_DECREF(index);
        goto fail;
    }
    {
        PyObject *nbucket = PyDict_GetItemWithError(index, new_status);
        if (nbucket == NULL) {
            if (PyErr_Occurred()) {
                Py_DECREF(index);
                goto fail;
            }
            nbucket = PyDict_New();
            if (nbucket == NULL ||
                PyDict_SetItem(index, new_status, nbucket) < 0) {
                Py_XDECREF(nbucket);
                Py_DECREF(index);
                goto fail;
            }
            Py_DECREF(nbucket); /* dict holds it; borrowed below */
            nbucket = PyDict_GetItemWithError(index, new_status);
            if (nbucket == NULL) {
                Py_DECREF(index);
                goto fail;
            }
        }
        if (PyDict_SetItem(nbucket, uid, task) < 0) {
            Py_DECREF(index);
            goto fail;
        }
    }
    if (bump_int_attr(job, s_status_version) < 0) {
        Py_DECREF(index);
        goto fail;
    }
    Py_DECREF(index);
    Py_DECREF(tasks);
    Py_DECREF(uid);
    return 0;
fail:
    Py_DECREF(tasks);
    Py_DECREF(uid);
    return -1;
}

/* ------------------------------------------------------------------ */
/* NodeInfo transition twins                                           */
/* ------------------------------------------------------------------ */

/* key = pod_key(task.pod) if task.pod else f"{ns}/{name}" — both arms are
 * "namespace/name"; pods built by new_task_info share the task's metadata,
 * and TaskInfo.key precomputes exactly this string. The node-map key is
 * re-derived from the pod when present, as the Python methods do. */
static PyObject *
node_map_key(PyObject *task)
{
    PyObject *pod = PyObject_GetAttr(task, s_pod);
    if (pod == NULL)
        return NULL;
    if (pod == Py_None) {
        Py_DECREF(pod);
        PyObject *ns = PyObject_GetAttr(task, s_namespace);
        PyObject *nm = ns ? PyObject_GetAttr(task, s_name) : NULL;
        PyObject *key = nm ? PyUnicode_FromFormat("%U/%U", ns, nm) : NULL;
        Py_XDECREF(ns);
        Py_XDECREF(nm);
        return key;
    }
    PyObject *meta = PyObject_GetAttr(pod, s_metadata);
    Py_DECREF(pod);
    if (meta == NULL)
        return NULL;
    PyObject *ns = PyObject_GetAttr(meta, s_namespace);
    PyObject *nm = ns ? PyObject_GetAttr(meta, s_name) : NULL;
    Py_DECREF(meta);
    PyObject *key = nm ? PyUnicode_FromFormat("%U/%U", ns, nm) : NULL;
    Py_XDECREF(ns);
    Py_XDECREF(nm);
    return key;
}

static int
status_eq(PyObject *a, PyObject *b)
{
    if (a == b)
        return 1;
    return PyObject_RichCompareBool(a, b, Py_EQ);
}

/* NodeInfo._allocate_idle twin: idle.sub(req) after the sufficiency gate;
 * on failure sets OutOfSync and raises RuntimeError (node_info.py:101-106). */
static int
node_allocate_idle(TransCtx *ctx, PyObject *node, PyObject *req)
{
    PyObject *idle = PyObject_GetAttr(node, s_idle);
    if (idle == NULL)
        return -1;
    int le = res_less_equal(req, idle);
    if (le < 0) {
        Py_DECREF(idle);
        return -1;
    }
    if (le) {
        int rc = res_sub(idle, req, ctx->assert_cb);
        Py_DECREF(idle);
        return rc;
    }
    Py_DECREF(idle);
    PyObject *st = PyObject_CallFunction(ctx->nodestate_cls, "Os",
                                         ctx->phase_notready, "OutOfSync");
    if (st == NULL)
        return -1;
    int rc = PyObject_SetAttr(node, s_state, st);
    Py_DECREF(st);
    if (rc < 0)
        return -1;
    PyErr_SetString(PyExc_RuntimeError, "Selected node NotReady");
    return -1;
}

/* NodeInfo.update_task fused twin (node_info.py:154-200); transitions the
 * fused path does not model delegate to the Python method. */
static int
node_update_task(TransCtx *ctx, PyObject *node, PyObject *task)
{
    PyObject *key = node_map_key(task);
    if (key == NULL)
        return -1;
    PyObject *tasks = PyObject_GetAttr(node, s_tasks);
    if (tasks == NULL) {
        Py_DECREF(key);
        return -1;
    }
    PyObject *cur = PyDict_GetItemWithError(tasks, key); /* borrowed */
    Py_DECREF(key);
    if (cur == NULL && PyErr_Occurred()) {
        Py_DECREF(tasks);
        return -1;
    }
    Py_DECREF(tasks);
    if (cur == NULL) {
        /* Python raises before bumping nothing else — delegate keeps the
         * message exact (it re-raises "failed to find task ... on host") */
        PyObject *r = PyObject_CallMethodObjArgs(node, s_update_task,
                                                 task, NULL);
        if (r == NULL)
            return -1;
        Py_DECREF(r);
        return 0;
    }
    PyObject *old_st = PyObject_GetAttr(cur, s_status);
    PyObject *new_st = old_st ? PyObject_GetAttr(task, s_status) : NULL;
    if (new_st == NULL) {
        Py_XDECREF(old_st);
        return -1;
    }
    PyObject *creq = PyObject_GetAttr(cur, s_resreq);
    PyObject *treq = creq ? PyObject_GetAttr(task, s_resreq) : NULL;
    if (treq == NULL) {
        Py_XDECREF(creq);
        Py_DECREF(old_st);
        Py_DECREF(new_st);
        return -1;
    }
    int req_mismatch = 0;
    if (creq != treq) {
        req_mismatch = PyObject_RichCompareBool(creq, treq, Py_NE);
        if (req_mismatch < 0)
            goto fail;
    }
    PyObject *nobj = PyObject_GetAttr(node, s_node);
    if (nobj == NULL)
        goto fail;
    int have_node = nobj != Py_None;
    Py_DECREF(nobj);
    int old_pipelined = status_eq(old_st, ctx->st_pipelined);
    int old_releasing = old_pipelined ? 0 : status_eq(old_st, ctx->st_releasing);
    int new_pipelined = status_eq(new_st, ctx->st_pipelined);
    int new_releasing = new_pipelined ? 0 : status_eq(new_st, ctx->st_releasing);
    if (old_pipelined < 0 || old_releasing < 0 || new_pipelined < 0 ||
        new_releasing < 0)
        goto fail;
    if (req_mismatch ||
        (have_node && (old_pipelined || (old_releasing && new_pipelined)))) {
        /* legacy remove+add path — delegate whole method */
        Py_DECREF(creq);
        Py_DECREF(treq);
        Py_DECREF(old_st);
        Py_DECREF(new_st);
        PyObject *r = PyObject_CallMethodObjArgs(node, s_update_task,
                                                 task, NULL);
        if (r == NULL)
            return -1;
        Py_DECREF(r);
        return 0;
    }
    if (bump_int_attr(node, s_acct_gen) < 0)
        goto fail;
    int st_same = status_eq(old_st, new_st);
    if (st_same < 0)
        goto fail;
    if (have_node && !st_same) {
        if (new_releasing && !old_releasing) {
            PyObject *rel = PyObject_GetAttr(node, s_releasing);
            if (rel == NULL)
                goto fail;
            int rc = res_add(rel, treq);
            Py_DECREF(rel);
            if (rc < 0)
                goto fail;
        } else if (old_releasing && !new_releasing) {
            PyObject *rel = PyObject_GetAttr(node, s_releasing);
            if (rel == NULL)
                goto fail;
            int rc = res_sub(rel, treq, ctx->assert_cb);
            Py_DECREF(rel);
            if (rc < 0)
                goto fail;
        } else if (new_pipelined) { /* allocated -> PIPELINED */
            PyObject *idle = PyObject_GetAttr(node, s_idle);
            if (idle == NULL)
                goto fail;
            int rc = res_add(idle, treq);
            Py_DECREF(idle);
            if (rc < 0)
                goto fail;
            PyObject *rel = PyObject_GetAttr(node, s_releasing);
            if (rel == NULL)
                goto fail;
            rc = res_sub(rel, treq, ctx->assert_cb);
            Py_DECREF(rel);
            if (rc < 0)
                goto fail;
        }
    }
    /* in-place refresh of the node-owned clone */
    if (PyObject_SetAttr(cur, s_status, new_st) < 0)
        goto fail;
    {
        static PyObject *copy_attrs[6];
        if (copy_attrs[0] == NULL) {
            copy_attrs[0] = s_node_name;
            copy_attrs[1] = s_priority;
            copy_attrs[2] = s_volume_ready;
            copy_attrs[3] = s_init_resreq;
            copy_attrs[4] = s_row;
            copy_attrs[5] = s_row_gen;
        }
        for (int i = 0; i < 6; i++) {
            PyObject *v = PyObject_GetAttr(task, copy_attrs[i]);
            if (v == NULL)
                goto fail;
            int rc = PyObject_SetAttr(cur, copy_attrs[i], v);
            Py_DECREF(v);
            if (rc < 0)
                goto fail;
        }
        PyObject *v = PyObject_GetAttr(task, s_pod);
        if (v == NULL)
            goto fail;
        int rc = PyObject_SetAttr(cur, s_pod, v);
        Py_DECREF(v);
        if (rc < 0)
            goto fail;
    }
    Py_DECREF(creq);
    Py_DECREF(treq);
    Py_DECREF(old_st);
    Py_DECREF(new_st);
    return 0;
fail:
    Py_DECREF(creq);
    Py_DECREF(treq);
    Py_DECREF(old_st);
    Py_DECREF(new_st);
    return -1;
}

/* NodeInfo.add_task twin (node_info.py:108-132). */
static int
node_add_task(TransCtx *ctx, PyObject *node, PyObject *task)
{
    if (bump_int_attr(node, s_acct_gen) < 0)
        return -1;
    PyObject *key = node_map_key(task);
    if (key == NULL)
        return -1;
    PyObject *tasks = PyObject_GetAttr(node, s_tasks);
    if (tasks == NULL) {
        Py_DECREF(key);
        return -1;
    }
    int contains = PyDict_Contains(tasks, key);
    if (contains < 0) {
        Py_DECREF(key);
        Py_DECREF(tasks);
        return -1;
    }
    if (contains) {
        PyObject *ns = PyObject_GetAttr(task, s_namespace);
        PyObject *nm = ns ? PyObject_GetAttr(task, s_name) : NULL;
        PyObject *nn = nm ? PyObject_GetAttr(node, s_name) : NULL;
        if (nn != NULL)
            PyErr_Format(PyExc_RuntimeError,
                         "task <%U/%U> already on node <%U>", ns, nm, nn);
        Py_XDECREF(ns);
        Py_XDECREF(nm);
        Py_XDECREF(nn);
        Py_DECREF(key);
        Py_DECREF(tasks);
        return -1;
    }
    PyObject *ti = PyObject_CallMethodObjArgs(task, s_shared_clone, NULL);
    if (ti == NULL) {
        Py_DECREF(key);
        Py_DECREF(tasks);
        return -1;
    }
    PyObject *nobj = PyObject_GetAttr(node, s_node);
    if (nobj == NULL)
        goto fail;
    int have_node = nobj != Py_None;
    Py_DECREF(nobj);
    if (have_node) {
        PyObject *st = PyObject_GetAttr(ti, s_status);
        PyObject *req = st ? PyObject_GetAttr(ti, s_resreq) : NULL;
        if (req == NULL) {
            Py_XDECREF(st);
            goto fail;
        }
        int is_rel = status_eq(st, ctx->st_releasing);
        int is_pipe = is_rel ? 0 : status_eq(st, ctx->st_pipelined);
        Py_DECREF(st);
        if (is_rel < 0 || is_pipe < 0) {
            Py_DECREF(req);
            goto fail;
        }
        int rc = 0;
        if (is_rel) {
            rc = node_allocate_idle(ctx, node, req);
            if (rc == 0) {
                PyObject *rel = PyObject_GetAttr(node, s_releasing);
                rc = rel ? res_add(rel, req) : -1;
                Py_XDECREF(rel);
            }
        } else if (is_pipe) {
            PyObject *rel = PyObject_GetAttr(node, s_releasing);
            rc = rel ? res_sub(rel, req, ctx->assert_cb) : -1;
            Py_XDECREF(rel);
        } else {
            rc = node_allocate_idle(ctx, node, req);
        }
        if (rc == 0) {
            PyObject *used = PyObject_GetAttr(node, s_used);
            rc = used ? res_add(used, req) : -1;
            Py_XDECREF(used);
        }
        Py_DECREF(req);
        if (rc < 0)
            goto fail;
    }
    if (PyDict_SetItem(tasks, key, ti) < 0)
        goto fail;
    Py_DECREF(ti);
    Py_DECREF(key);
    Py_DECREF(tasks);
    return 0;
fail:
    Py_DECREF(ti);
    Py_DECREF(key);
    Py_DECREF(tasks);
    return -1;
}

/* NodeInfo.remove_task twin (node_info.py:134-152). */
static int
node_remove_task(TransCtx *ctx, PyObject *node, PyObject *task)
{
    if (bump_int_attr(node, s_acct_gen) < 0)
        return -1;
    PyObject *key = node_map_key(task);
    if (key == NULL)
        return -1;
    PyObject *tasks = PyObject_GetAttr(node, s_tasks);
    if (tasks == NULL) {
        Py_DECREF(key);
        return -1;
    }
    PyObject *cur = PyDict_GetItemWithError(tasks, key); /* borrowed */
    if (cur == NULL) {
        if (!PyErr_Occurred()) {
            PyObject *ns = PyObject_GetAttr(task, s_namespace);
            PyObject *nm = ns ? PyObject_GetAttr(task, s_name) : NULL;
            PyObject *nn = nm ? PyObject_GetAttr(node, s_name) : NULL;
            if (nn != NULL)
                PyErr_Format(PyExc_RuntimeError,
                             "failed to find task <%U/%U> on host <%U>",
                             ns, nm, nn);
            Py_XDECREF(ns);
            Py_XDECREF(nm);
            Py_XDECREF(nn);
        }
        Py_DECREF(key);
        Py_DECREF(tasks);
        return -1;
    }
    Py_INCREF(cur); /* keep alive across the del below */
    PyObject *nobj = PyObject_GetAttr(node, s_node);
    if (nobj == NULL)
        goto fail;
    int have_node = nobj != Py_None;
    Py_DECREF(nobj);
    if (have_node) {
        PyObject *st = PyObject_GetAttr(cur, s_status);
        PyObject *req = st ? PyObject_GetAttr(cur, s_resreq) : NULL;
        if (req == NULL) {
            Py_XDECREF(st);
            goto fail;
        }
        int is_rel = status_eq(st, ctx->st_releasing);
        int is_pipe = is_rel ? 0 : status_eq(st, ctx->st_pipelined);
        Py_DECREF(st);
        if (is_rel < 0 || is_pipe < 0) {
            Py_DECREF(req);
            goto fail;
        }
        int rc = 0;
        if (is_rel) {
            PyObject *rel = PyObject_GetAttr(node, s_releasing);
            rc = rel ? res_sub(rel, req, ctx->assert_cb) : -1;
            Py_XDECREF(rel);
            if (rc == 0) {
                PyObject *idle = PyObject_GetAttr(node, s_idle);
                rc = idle ? res_add(idle, req) : -1;
                Py_XDECREF(idle);
            }
        } else if (is_pipe) {
            PyObject *rel = PyObject_GetAttr(node, s_releasing);
            rc = rel ? res_add(rel, req) : -1;
            Py_XDECREF(rel);
        } else {
            PyObject *idle = PyObject_GetAttr(node, s_idle);
            rc = idle ? res_add(idle, req) : -1;
            Py_XDECREF(idle);
        }
        if (rc == 0) {
            PyObject *used = PyObject_GetAttr(node, s_used);
            rc = used ? res_sub(used, req, ctx->assert_cb) : -1;
            Py_XDECREF(used);
        }
        Py_DECREF(req);
        if (rc < 0)
            goto fail;
    }
    if (PyDict_DelItem(tasks, key) < 0)
        goto fail;
    Py_DECREF(cur);
    Py_DECREF(key);
    Py_DECREF(tasks);
    return 0;
fail:
    Py_DECREF(cur);
    Py_DECREF(key);
    Py_DECREF(tasks);
    return -1;
}

/* ------------------------------------------------------------------ */
/* plugin event-handler twins                                          */
/* ------------------------------------------------------------------ */

/* drf._update_share twin: allocated add/sub + share recompute over the
 * session-static total pairs (drf.py:52-73). */
static int
drf_attr_update(TransCtx *ctx, PyObject *attr, PyObject *req, int sign)
{
    PyObject *alloc = PyObject_GetAttr(attr, s_allocated);
    if (alloc == NULL)
        return -1;
    int rc = sign > 0 ? res_add(alloc, req)
                      : res_sub(alloc, req, ctx->assert_cb);
    if (rc < 0) {
        Py_DECREF(alloc);
        return -1;
    }
    double best = 0.0;
    PyObject *dominant = NULL; /* borrowed */
    Py_ssize_t n = PyList_GET_SIZE(ctx->drf_pairs);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *pair = PyList_GET_ITEM(ctx->drf_pairs, i);
        PyObject *rn = PyTuple_GET_ITEM(pair, 0);
        double tv = PyFloat_AsDouble(PyTuple_GET_ITEM(pair, 1));
        if (tv == -1.0 && PyErr_Occurred()) {
            Py_DECREF(alloc);
            return -1;
        }
        double l;
        if (res_get_named(alloc, rn, &l) < 0) {
            Py_DECREF(alloc);
            return -1;
        }
        double s = tv == 0.0 ? (l == 0.0 ? 0.0 : 1.0) : l / tv;
        if (s > best) {
            best = s;
            dominant = rn;
        }
    }
    Py_DECREF(alloc);
    if (dominant == NULL) {
        /* share 0.0, dominant "" — mirror _calculate_share's defaults */
        PyObject *empty = PyUnicode_FromString("");
        if (empty == NULL)
            return -1;
        rc = PyObject_SetAttr(attr, s_dominant_resource, empty);
        Py_DECREF(empty);
        if (rc < 0)
            return -1;
    } else if (PyObject_SetAttr(attr, s_dominant_resource, dominant) < 0) {
        return -1;
    }
    return set_f64(attr, s_share, best);
}

/* drf on_allocate/on_deallocate (plugins/drf.py:170-186), including the
 * namespace-order arm when enabled (namespace_opts keyed by namespace). */
static int
drf_update(TransCtx *ctx, PyObject *task, int sign)
{
    if (ctx->drf_attrs == Py_None)
        return 0;
    PyObject *jobuid = PyObject_GetAttr(task, s_job);
    if (jobuid == NULL)
        return -1;
    PyObject *attr = dict_get(ctx->drf_attrs, jobuid, 1);
    Py_DECREF(jobuid);
    if (attr == NULL)
        return -1;
    PyObject *req = PyObject_GetAttr(task, s_resreq);
    if (req == NULL)
        return -1;
    if (drf_attr_update(ctx, attr, req, sign) < 0) {
        Py_DECREF(req);
        return -1;
    }
    if (ctx->drf_ns_attrs != Py_None) {
        PyObject *ns = PyObject_GetAttr(task, s_namespace);
        if (ns == NULL) {
            Py_DECREF(req);
            return -1;
        }
        PyObject *ns_attr = dict_get(ctx->drf_ns_attrs, ns, 1);
        Py_DECREF(ns);
        if (ns_attr == NULL || drf_attr_update(ctx, ns_attr, req, sign) < 0) {
            Py_DECREF(req);
            return -1;
        }
    }
    Py_DECREF(req);
    return 0;
}

/* proportion on_allocate/on_deallocate (plugins/proportion.py:156-166). */
static int
prop_update(TransCtx *ctx, PyObject *task, int sign)
{
    if (ctx->prop_attrs == Py_None)
        return 0;
    PyObject *jobuid = PyObject_GetAttr(task, s_job);
    if (jobuid == NULL)
        return -1;
    PyObject *job = dict_get(ctx->jobs, jobuid, 1); /* ssn.jobs[...] raises */
    Py_DECREF(jobuid);
    if (job == NULL)
        return -1;
    PyObject *queue = PyObject_GetAttr(job, s_queue);
    if (queue == NULL)
        return -1;
    PyObject *attr = dict_get(ctx->prop_attrs, queue, 1);
    Py_DECREF(queue);
    if (attr == NULL)
        return -1;
    PyObject *alloc = PyObject_GetAttr(attr, s_allocated);
    PyObject *req = alloc ? PyObject_GetAttr(task, s_resreq) : NULL;
    if (req == NULL) {
        Py_XDECREF(alloc);
        return -1;
    }
    int rc = sign > 0 ? res_add(alloc, req)
                      : res_sub(alloc, req, ctx->assert_cb);
    Py_DECREF(req);
    if (rc < 0) {
        Py_DECREF(alloc);
        return -1;
    }
    /* _update_share: max over deserved.resource_names() of
     * share(allocated.get(rn), deserved.get(rn)) */
    PyObject *deserved = PyObject_GetAttr(attr, s_deserved);
    if (deserved == NULL) {
        Py_DECREF(alloc);
        return -1;
    }
    double best = 0.0;
    double l, r;
    /* "cpu" then "memory" then scalar map order — resource_names() order */
    if (get_f64(alloc, s_milli_cpu, &l) < 0 ||
        get_f64(deserved, s_milli_cpu, &r) < 0)
        goto fail;
    double s = r == 0.0 ? (l == 0.0 ? 0.0 : 1.0) : l / r;
    if (s > best)
        best = s;
    if (get_f64(alloc, s_memory, &l) < 0 ||
        get_f64(deserved, s_memory, &r) < 0)
        goto fail;
    s = r == 0.0 ? (l == 0.0 ? 0.0 : 1.0) : l / r;
    if (s > best)
        best = s;
    {
        PyObject *ds = PyObject_GetAttr(deserved, s_scalar_resources);
        if (ds == NULL)
            goto fail;
        if (ds != Py_None) {
            PyObject *name, *quant;
            Py_ssize_t pos = 0;
            while (PyDict_Next(ds, &pos, &name, &quant)) {
                r = PyFloat_AsDouble(quant);
                if (r == -1.0 && PyErr_Occurred()) {
                    Py_DECREF(ds);
                    goto fail;
                }
                if (res_get_named(alloc, name, &l) < 0) {
                    Py_DECREF(ds);
                    goto fail;
                }
                s = r == 0.0 ? (l == 0.0 ? 0.0 : 1.0) : l / r;
                if (s > best)
                    best = s;
            }
        }
        Py_DECREF(ds);
    }
    Py_DECREF(alloc);
    Py_DECREF(deserved);
    return set_f64(attr, s_share, best);
fail:
    Py_DECREF(alloc);
    Py_DECREF(deserved);
    return -1;
}

/* ------------------------------------------------------------------ */
/* ctx methods: whole transitions                                      */
/* ------------------------------------------------------------------ */

static int
log_swallowed(TransCtx *ctx, const char *fmt, PyObject *a, PyObject *b)
{
    /* logger.error(fmt-with-%s, a[, b], err) — mirror of the try/except
     * logging in statement.py; the pending exception becomes the last %s
     * arg. b may be NULL for the 2-operand log lines. */
    PyObject *etype, *evalue, *etb;
    PyErr_Fetch(&etype, &evalue, &etb);
    PyObject *emsg = evalue ? PyObject_Str(evalue) : PyUnicode_FromString("");
    PyObject *r = NULL;
    if (emsg != NULL) {
        if (b != NULL)
            r = PyObject_CallMethod(ctx->logger, "error", "sOOO",
                                    fmt, a, b, emsg);
        else
            r = PyObject_CallMethod(ctx->logger, "error", "sOO",
                                    fmt, a, emsg);
    }
    Py_XDECREF(emsg);
    Py_XDECREF(etype);
    Py_XDECREF(evalue);
    Py_XDECREF(etb);
    if (r == NULL)
        return -1;
    Py_DECREF(r);
    return 0;
}

/* evict(task, strict) -> bool: statement.evict / session.evict mutation
 * core: job bucket flip to RELEASING + node transition + drf/prop
 * deallocate. strict=1 raises KeyError on a missing job (session.evict
 * semantics); strict=0 skips it (statement semantics). Returns True when
 * the status actually flipped to RELEASING — the predicates deallocate
 * tracker is a no-op then; on False (missing job, non-strict) the task's
 * status is untouched and the caller MUST fire the tracker. */
static PyObject *
TransCtx_evict(TransCtx *self, PyObject *args)
{
    PyObject *task;
    int strict;
    if (!PyArg_ParseTuple(args, "Op", &task, &strict))
        return NULL;
    PyObject *jobuid = PyObject_GetAttr(task, s_job);
    if (jobuid == NULL)
        return NULL;
    PyObject *job = PyDict_GetItemWithError(self->jobs, jobuid);
    if (job == NULL && PyErr_Occurred()) {
        Py_DECREF(jobuid);
        return NULL;
    }
    if (job == NULL && strict) {
        PyErr_Format(PyExc_KeyError, "failed to find job %U", jobuid);
        Py_DECREF(jobuid);
        return NULL;
    }
    Py_DECREF(jobuid);
    if (job != NULL &&
        job_update_task_status(self, job, task, self->st_releasing) < 0)
        return NULL;
    PyObject *host = PyObject_GetAttr(task, s_node_name);
    if (host == NULL)
        return NULL;
    PyObject *node = PyDict_GetItemWithError(self->nodes, host);
    Py_DECREF(host);
    if (node == NULL && PyErr_Occurred())
        return NULL;
    if (node != NULL && node_update_task(self, node, task) < 0)
        return NULL;
    if (drf_update(self, task, -1) < 0)
        return NULL;
    if (prop_update(self, task, -1) < 0)
        return NULL;
    if (job != NULL)
        Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

/* pipeline(task, hostname, strict): status flip to PIPELINED + node
 * add_task + drf/prop allocate. strict=1: session.pipeline KeyErrors;
 * strict=0: statement.pipeline (missing job/node skipped, add_task
 * RuntimeError swallowed with a log line). The caller (ops/fasttrans.py)
 * fires the predicates allocate tracker afterwards. */
static PyObject *
TransCtx_pipeline(TransCtx *self, PyObject *args)
{
    PyObject *task, *hostname;
    int strict;
    if (!PyArg_ParseTuple(args, "OOp", &task, &hostname, &strict))
        return NULL;
    PyObject *jobuid = PyObject_GetAttr(task, s_job);
    if (jobuid == NULL)
        return NULL;
    PyObject *job = PyDict_GetItemWithError(self->jobs, jobuid);
    if (job == NULL && PyErr_Occurred()) {
        Py_DECREF(jobuid);
        return NULL;
    }
    if (job == NULL && strict) {
        PyErr_Format(PyExc_KeyError, "failed to find job %U when pipelining",
                     jobuid);
        Py_DECREF(jobuid);
        return NULL;
    }
    Py_DECREF(jobuid);
    if (job != NULL &&
        job_update_task_status(self, job, task, self->st_pipelined) < 0)
        return NULL;
    if (PyObject_SetAttr(task, s_node_name, hostname) < 0)
        return NULL;
    PyObject *node = PyDict_GetItemWithError(self->nodes, hostname);
    if (node == NULL && PyErr_Occurred())
        return NULL;
    if (node == NULL && strict) {
        PyErr_Format(PyExc_KeyError, "failed to find node %U", hostname);
        return NULL;
    }
    if (node != NULL && node_add_task(self, node, task) < 0) {
        if (strict || !PyErr_ExceptionMatches(PyExc_RuntimeError))
            return NULL;
        PyObject *tname = PyObject_GetAttr(task, s_name);
        if (tname == NULL)
            return NULL;
        int rc = log_swallowed(self, "failed to pipeline task %s to %s: %s",
                               tname, hostname);
        Py_DECREF(tname);
        if (rc < 0)
            return NULL;
    }
    if (drf_update(self, task, 1) < 0)
        return NULL;
    if (prop_update(self, task, 1) < 0)
        return NULL;
    Py_RETURN_NONE;
}

/* unevict(task): statement discard twin of evict — status back to
 * RUNNING, node transition, drf/prop allocate (statement.py:48-60).
 * Caller fires the predicates allocate tracker afterwards. */
static PyObject *
TransCtx_unevict(TransCtx *self, PyObject *args)
{
    PyObject *task;
    if (!PyArg_ParseTuple(args, "O", &task))
        return NULL;
    PyObject *jobuid = PyObject_GetAttr(task, s_job);
    if (jobuid == NULL)
        return NULL;
    PyObject *job = PyDict_GetItemWithError(self->jobs, jobuid);
    Py_DECREF(jobuid);
    if (job == NULL && PyErr_Occurred())
        return NULL;
    if (job != NULL &&
        job_update_task_status(self, job, task, self->st_running) < 0)
        return NULL;
    PyObject *host = PyObject_GetAttr(task, s_node_name);
    if (host == NULL)
        return NULL;
    PyObject *node = PyDict_GetItemWithError(self->nodes, host);
    Py_DECREF(host);
    if (node == NULL && PyErr_Occurred())
        return NULL;
    if (node != NULL && node_update_task(self, node, task) < 0)
        return NULL;
    if (drf_update(self, task, 1) < 0)
        return NULL;
    if (prop_update(self, task, 1) < 0)
        return NULL;
    Py_RETURN_NONE;
}

/* unpipeline(task): statement discard twin of pipeline
 * (statement.py:80-92). Caller fires the predicates deallocate tracker
 * afterwards (status is PENDING — its label-index removal is real). */
static PyObject *
TransCtx_unpipeline(TransCtx *self, PyObject *args)
{
    PyObject *task;
    if (!PyArg_ParseTuple(args, "O", &task))
        return NULL;
    PyObject *jobuid = PyObject_GetAttr(task, s_job);
    if (jobuid == NULL)
        return NULL;
    PyObject *job = PyDict_GetItemWithError(self->jobs, jobuid);
    Py_DECREF(jobuid);
    if (job == NULL && PyErr_Occurred())
        return NULL;
    if (job != NULL &&
        job_update_task_status(self, job, task, self->st_pending) < 0)
        return NULL;
    PyObject *host = PyObject_GetAttr(task, s_node_name);
    if (host == NULL)
        return NULL;
    PyObject *node = PyDict_GetItemWithError(self->nodes, host);
    if (node == NULL && PyErr_Occurred()) {
        Py_DECREF(host);
        return NULL;
    }
    if (node != NULL && node_remove_task(self, node, task) < 0) {
        if (!PyErr_ExceptionMatches(PyExc_RuntimeError)) {
            Py_DECREF(host);
            return NULL;
        }
        PyObject *tname = PyObject_GetAttr(task, s_name);
        if (tname == NULL) {
            Py_DECREF(host);
            return NULL;
        }
        int rc = log_swallowed(self, "failed to unpipeline task %s: %s",
                               tname, NULL);
        Py_DECREF(tname);
        if (rc < 0) {
            Py_DECREF(host);
            return NULL;
        }
    }
    Py_DECREF(host);
    PyObject *empty = PyUnicode_FromString("");
    if (empty == NULL)
        return NULL;
    int rc = PyObject_SetAttr(task, s_node_name, empty);
    Py_DECREF(empty);
    if (rc < 0)
        return NULL;
    if (drf_update(self, task, -1) < 0)
        return NULL;
    if (prop_update(self, task, -1) < 0)
        return NULL;
    Py_RETURN_NONE;
}

/* allocate(task, hostname): session.allocate mutation core (status flip
 * to ALLOCATED + node add_task + drf/prop allocate); the gang-ready
 * dispatch loop stays in the Python caller. Both lookups raise, as
 * session.allocate does. Caller fires the predicates allocate tracker. */
static PyObject *
TransCtx_allocate(TransCtx *self, PyObject *args)
{
    PyObject *task, *hostname;
    if (!PyArg_ParseTuple(args, "OO", &task, &hostname))
        return NULL;
    PyObject *jobuid = PyObject_GetAttr(task, s_job);
    if (jobuid == NULL)
        return NULL;
    PyObject *job = PyDict_GetItemWithError(self->jobs, jobuid);
    if (job == NULL) {
        if (!PyErr_Occurred())
            PyErr_Format(PyExc_KeyError, "failed to find job %U", jobuid);
        Py_DECREF(jobuid);
        return NULL;
    }
    Py_DECREF(jobuid);
    if (job_update_task_status(self, job, task, self->st_allocated) < 0)
        return NULL;
    if (PyObject_SetAttr(task, s_node_name, hostname) < 0)
        return NULL;
    PyObject *node = PyDict_GetItemWithError(self->nodes, hostname);
    if (node == NULL) {
        if (!PyErr_Occurred())
            PyErr_Format(PyExc_KeyError, "failed to find node %U", hostname);
        return NULL;
    }
    if (node_add_task(self, node, task) < 0)
        return NULL;
    if (drf_update(self, task, 1) < 0)
        return NULL;
    if (prop_update(self, task, 1) < 0)
        return NULL;
    Py_INCREF(job);
    return job; /* the caller's gang-ready check needs it anyway */
}

/* mirror_evict(task_info) -> (cache_task, pod): the cache-side mutation
 * of SchedulerCache.evict (cache.py:417-425) under the caller-held lock:
 * find the cache's own job/task, flip to RELEASING, node transition.
 * Returns the cache's task (for resync on effector failure) and its pod
 * (for the evictor/event calls). */
static PyObject *
TransCtx_mirror_evict(TransCtx *self, PyObject *args)
{
    PyObject *ti;
    if (!PyArg_ParseTuple(args, "O", &ti))
        return NULL;
    PyObject *jobuid = PyObject_GetAttr(ti, s_job);
    if (jobuid == NULL)
        return NULL;
    PyObject *job = PyDict_GetItemWithError(self->jobs, jobuid);
    if (job == NULL) {
        if (!PyErr_Occurred()) {
            PyObject *uid = PyObject_GetAttr(ti, s_uid);
            if (uid != NULL)
                PyErr_Format(PyExc_KeyError,
                             "failed to find Job %U for Task %U",
                             jobuid, uid);
            Py_XDECREF(uid);
        }
        Py_DECREF(jobuid);
        return NULL;
    }
    Py_DECREF(jobuid);
    PyObject *uid = PyObject_GetAttr(ti, s_uid);
    if (uid == NULL)
        return NULL;
    PyObject *jtasks = PyObject_GetAttr(job, s_tasks);
    if (jtasks == NULL) {
        Py_DECREF(uid);
        return NULL;
    }
    PyObject *task = PyDict_GetItemWithError(jtasks, uid); /* borrowed */
    Py_DECREF(jtasks);
    if (task == NULL) {
        if (!PyErr_Occurred()) {
            PyObject *st = PyObject_GetAttr(ti, s_status);
            PyObject *sts = st ? PyObject_Str(st) : NULL;
            if (sts != NULL)
                PyErr_Format(PyExc_KeyError,
                             "failed to find task in status %U by id %U",
                             sts, uid);
            Py_XDECREF(st);
            Py_XDECREF(sts);
        }
        Py_DECREF(uid);
        return NULL;
    }
    Py_DECREF(uid);
    Py_INCREF(task);
    PyObject *host = PyObject_GetAttr(task, s_node_name);
    if (host == NULL) {
        Py_DECREF(task);
        return NULL;
    }
    PyObject *node = PyDict_GetItemWithError(self->nodes, host);
    if (node == NULL) {
        if (!PyErr_Occurred()) {
            PyObject *tuid = PyObject_GetAttr(task, s_uid);
            if (tuid != NULL)
                PyErr_Format(PyExc_KeyError,
                             "failed to evict Task %U: host %U does not exist",
                             tuid, host);
            Py_XDECREF(tuid);
        }
        Py_DECREF(host);
        Py_DECREF(task);
        return NULL;
    }
    Py_DECREF(host);
    if (job_update_task_status(self, job, task, self->st_releasing) < 0) {
        Py_DECREF(task);
        return NULL;
    }
    if (node_update_task(self, node, task) < 0) {
        Py_DECREF(task);
        return NULL;
    }
    PyObject *pod = PyObject_GetAttr(task, s_pod);
    if (pod == NULL) {
        Py_DECREF(task);
        return NULL;
    }
    PyObject *out = PyTuple_Pack(2, task, pod);
    Py_DECREF(task);
    Py_DECREF(pod);
    return out;
}

/* mirror_bind(task_info, hostname) -> (cache_task, pod): cache-side
 * mutation of SchedulerCache.bind (cache.py:394-405) under the
 * caller-held lock. */
static PyObject *
TransCtx_mirror_bind(TransCtx *self, PyObject *args)
{
    PyObject *ti, *hostname;
    if (!PyArg_ParseTuple(args, "OO", &ti, &hostname))
        return NULL;
    PyObject *jobuid = PyObject_GetAttr(ti, s_job);
    if (jobuid == NULL)
        return NULL;
    PyObject *job = PyDict_GetItemWithError(self->jobs, jobuid);
    if (job == NULL) {
        if (!PyErr_Occurred()) {
            PyObject *uid = PyObject_GetAttr(ti, s_uid);
            if (uid != NULL)
                PyErr_Format(PyExc_KeyError,
                             "failed to find Job %U for Task %U",
                             jobuid, uid);
            Py_XDECREF(uid);
        }
        Py_DECREF(jobuid);
        return NULL;
    }
    Py_DECREF(jobuid);
    PyObject *uid = PyObject_GetAttr(ti, s_uid);
    if (uid == NULL)
        return NULL;
    PyObject *jtasks = PyObject_GetAttr(job, s_tasks);
    if (jtasks == NULL) {
        Py_DECREF(uid);
        return NULL;
    }
    PyObject *task = PyDict_GetItemWithError(jtasks, uid); /* borrowed */
    Py_DECREF(jtasks);
    if (task == NULL) {
        if (!PyErr_Occurred()) {
            PyObject *st = PyObject_GetAttr(ti, s_status);
            PyObject *sts = st ? PyObject_Str(st) : NULL;
            if (sts != NULL)
                PyErr_Format(PyExc_KeyError,
                             "failed to find task in status %U by id %U",
                             sts, uid);
            Py_XDECREF(st);
            Py_XDECREF(sts);
        }
        Py_DECREF(uid);
        return NULL;
    }
    Py_DECREF(uid);
    Py_INCREF(task);
    PyObject *node = PyDict_GetItemWithError(self->nodes, hostname);
    if (node == NULL) {
        if (!PyErr_Occurred()) {
            PyObject *tuid = PyObject_GetAttr(task, s_uid);
            if (tuid != NULL)
                PyErr_Format(
                    PyExc_KeyError,
                    "failed to bind Task %U to host %U: host does not exist",
                    tuid, hostname);
            Py_XDECREF(tuid);
        }
        Py_DECREF(task);
        return NULL;
    }
    if (job_update_task_status(self, job, task, self->st_binding) < 0) {
        Py_DECREF(task);
        return NULL;
    }
    if (PyObject_SetAttr(task, s_node_name, hostname) < 0) {
        Py_DECREF(task);
        return NULL;
    }
    if (node_add_task(self, node, task) < 0) {
        Py_DECREF(task);
        return NULL;
    }
    PyObject *pod = PyObject_GetAttr(task, s_pod);
    if (pod == NULL) {
        Py_DECREF(task);
        return NULL;
    }
    PyObject *out = PyTuple_Pack(2, task, pod);
    Py_DECREF(task);
    Py_DECREF(pod);
    return out;
}

/* ------------------------------------------------------------------ */
/* module-level: candidate-stream head pick                            */
/* ------------------------------------------------------------------ */

/* pick_first(idx_i64, row_f64, rr, num_to_find, n) -> (best_pos, processed)
 *
 * The head of DensePreemptView.candidates' stream (preempt/reclaim
 * consume exactly one element in practice): over the round-robin window
 * of the sorted eligible-node index array `idx` (same arithmetic as the
 * Python path — split at the cursor, take num_to_find circularly, else
 * the full circle), return the POSITION IN idx of the first maximum of
 * row[idx[...]] in window order (== head of the stable descending sort)
 * and the cursor advance. Pure C twin of candidates()'s selection math;
 * the Python generator remains the oracle and the continuation path. */
static PyObject *
fasttrans_pick_first(PyObject *self, PyObject *args)
{
    PyObject *idx_obj, *row_obj;
    long long rr, ntf, n;
    if (!PyArg_ParseTuple(args, "OOLLL", &idx_obj, &row_obj, &rr, &ntf, &n))
        return NULL;
    Py_buffer idx_buf, row_buf;
    if (PyObject_GetBuffer(idx_obj, &idx_buf, PyBUF_CONTIG_RO) < 0)
        return NULL;
    if (PyObject_GetBuffer(row_obj, &row_buf, PyBUF_CONTIG_RO) < 0) {
        PyBuffer_Release(&idx_buf);
        return NULL;
    }
    if (idx_buf.itemsize != 8 || row_buf.itemsize != 8) {
        PyBuffer_Release(&idx_buf);
        PyBuffer_Release(&row_buf);
        PyErr_SetString(PyExc_TypeError,
                        "pick_first: expected int64 idx and float64 row");
        return NULL;
    }
    const long long *idx = (const long long *)idx_buf.buf;
    const double *row = (const double *)row_buf.buf;
    Py_ssize_t ft = idx_buf.len / 8;
    long long processed;
    Py_ssize_t best_pos = -1;
    double best = 0.0;
    if (ft == 0) {
        processed = 0;
    } else {
        /* split = lower_bound(idx, rr) */
        Py_ssize_t lo = 0, hi = ft;
        while (lo < hi) {
            Py_ssize_t mid = (lo + hi) / 2;
            if (idx[mid] < rr)
                lo = mid + 1;
            else
                hi = mid;
        }
        Py_ssize_t split = lo;
        Py_ssize_t take_tail, wrap;
        if (ft >= ntf) {
            take_tail = ft - split < ntf ? ft - split : (Py_ssize_t)ntf;
            wrap = (Py_ssize_t)ntf - take_tail;
            long long last = wrap > 0 ? idx[wrap - 1]
                                      : idx[split + take_tail - 1];
            processed = ((last - rr) % n + n) % n + 1;
        } else {
            take_tail = ft - split;
            wrap = split;
            processed = n;
        }
        /* first max in WINDOW order (== stable descending-sort head);
         * best_pos < 0 seeds in BOTH loops — an all-wrap window (cursor
         * past every eligible index) with non-positive scores must still
         * yield its first element, exactly as np.argmax does */
        for (Py_ssize_t i = 0; i < take_tail; i++) {
            double s = row[idx[split + i]];
            if (best_pos < 0 || s > best) {
                best = s;
                best_pos = split + i;
            }
        }
        for (Py_ssize_t i = 0; i < wrap; i++) {
            double s = row[idx[i]];
            if (best_pos < 0 || s > best) {
                best = s;
                best_pos = i;
            }
        }
    }
    PyBuffer_Release(&idx_buf);
    PyBuffer_Release(&row_buf);
    return Py_BuildValue("nL", best_pos, processed);
}

static PyMethodDef fasttrans_functions[] = {
    {"pick_first", fasttrans_pick_first, METH_VARARGS, NULL},
    {NULL, NULL, 0, NULL},
};

static PyMethodDef TransCtx_methods[] = {
    {"evict", (PyCFunction)TransCtx_evict, METH_VARARGS, NULL},
    {"pipeline", (PyCFunction)TransCtx_pipeline, METH_VARARGS, NULL},
    {"unevict", (PyCFunction)TransCtx_unevict, METH_VARARGS, NULL},
    {"unpipeline", (PyCFunction)TransCtx_unpipeline, METH_VARARGS, NULL},
    {"allocate", (PyCFunction)TransCtx_allocate, METH_VARARGS, NULL},
    {"mirror_evict", (PyCFunction)TransCtx_mirror_evict, METH_VARARGS, NULL},
    {"mirror_bind", (PyCFunction)TransCtx_mirror_bind, METH_VARARGS, NULL},
    {NULL, NULL, 0, NULL},
};

static PyTypeObject TransCtxType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "_fasttrans.TransCtx",
    .tp_basicsize = sizeof(TransCtx),
    .tp_dealloc = (destructor)TransCtx_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_methods = TransCtx_methods,
    .tp_init = (initproc)TransCtx_init,
    .tp_new = PyType_GenericNew,
};

static struct PyModuleDef fasttrans_module = {
    PyModuleDef_HEAD_INIT, "_fasttrans",
    "native per-operation transition engine", -1, fasttrans_functions,
};

PyMODINIT_FUNC
PyInit__fasttrans(void)
{
    if (intern_all() < 0)
        return NULL;
    if (PyType_Ready(&TransCtxType) < 0)
        return NULL;
    PyObject *m = PyModule_Create(&fasttrans_module);
    if (m == NULL)
        return NULL;
    Py_INCREF(&TransCtxType);
    if (PyModule_AddObject(m, "TransCtx", (PyObject *)&TransCtxType) < 0) {
        Py_DECREF(&TransCtxType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
