/* fastapply — native inner loop of the bulk placement writeback.
 *
 * The reference's scheduler is compiled Go; this framework's control plane
 * is Python with the placement solve on the GPU, which leaves the per-task
 * writeback (status flips, node task-map inserts, cache mirror updates) as
 * interpreted overhead on the session's critical path, once per placed
 * task. This module is the native equivalent of that loop:
 * identical semantics to the Python body in ops/solver.py::_apply_bulk
 * (which remains the fallback and the behavioral oracle), minus the
 * interpreter dispatch.
 *
 * Called per job segment with the job's pre-resolved dicts; the GIL is
 * held throughout (all operations are object mutations).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

static PyObject *s_node_name, *s_status, *s_uid, *s_namespace, *s_name,
    *s_tasks, *s_pod, *s_status_version, *s_task_status_index, *s_allocated,
    *s_key, *s_acct_gen, *s_pending_sum, *s_resreq, *s_milli_cpu_g,
    *s_memory_g, *s_scalar_res_g;

/* apply_job_tasks(tis, task_infos, assign, node_names, binding,
 *                 s_pending, s_binding, c_tasks, c_pending, c_binding,
 *                 ssn_nodes, cache_nodes, bind_tasks, bind_hosts)
 *
 * tis: list[int] task indices (one job's placements)
 * task_infos / node_names: session decode lists
 * assign: list[int] node index per task
 * binding: the TaskStatus.BINDING enum member
 * s_pending: dict | None  (session job PENDING bucket; None => moved)
 * s_binding: dict         (session job BINDING bucket)
 * c_tasks / c_pending / c_binding: cache-job analogs (or None)
 * ssn_nodes / cache_nodes: name -> NodeInfo dicts (cache_nodes may be None)
 * bind_tasks / bind_pods / bind_hosts: output lists, appended in task
 * order (pods pre-extracted here so the binder dispatch needs no 50k
 * Python-level `.pod` getattrs)
 */
static PyObject *
apply_job_tasks(PyObject *self, PyObject *args)
{
    PyObject *tis, *task_infos, *assign, *node_names, *binding;
    PyObject *s_pending, *s_binding_d, *c_tasks, *c_pending, *c_binding;
    PyObject *ssn_nodes, *cache_nodes, *bind_tasks, *bind_pods, *bind_hosts;

    if (!PyArg_ParseTuple(args, "OOOOOOOOOOOOOOO",
                          &tis, &task_infos, &assign, &node_names, &binding,
                          &s_pending, &s_binding_d, &c_tasks, &c_pending,
                          &c_binding, &ssn_nodes, &cache_nodes,
                          &bind_tasks, &bind_pods, &bind_hosts))
        return NULL;

    int have_s_pending = s_pending != Py_None;
    int have_c = c_tasks != Py_None;
    int have_c_pending = c_pending != Py_None;
    int have_cache_nodes = cache_nodes != Py_None;

    Py_ssize_t n = PyList_GET_SIZE(tis);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *ti_obj = PyList_GET_ITEM(tis, i);          /* borrowed */
        Py_ssize_t ti = PyLong_AsSsize_t(ti_obj);
        if (ti < 0 && PyErr_Occurred())
            return NULL;
        PyObject *task = PyList_GET_ITEM(task_infos, ti);    /* borrowed */
        PyObject *ni_obj = PyList_GET_ITEM(assign, ti);      /* borrowed */
        Py_ssize_t ni = PyLong_AsSsize_t(ni_obj);
        if (ni < 0 && PyErr_Occurred())
            return NULL;
        PyObject *host = PyList_GET_ITEM(node_names, ni);    /* borrowed */

        if (PyObject_SetAttr(task, s_node_name, host) < 0)
            return NULL;
        if (PyObject_SetAttr(task, s_status, binding) < 0)
            return NULL;

        PyObject *uid = PyObject_GetAttr(task, s_uid);       /* new */
        if (uid == NULL)
            return NULL;

        if (have_s_pending) {
            if (PyDict_DelItem(s_pending, uid) < 0) {
                /* pop(uid, None): only absence is swallowed — any other
                 * failure (unhashable uid, comparison error) propagates */
                if (!PyErr_ExceptionMatches(PyExc_KeyError)) {
                    Py_DECREF(uid);
                    return NULL;
                }
                PyErr_Clear();
            }
            if (PyDict_SetItem(s_binding_d, uid, task) < 0) {
                Py_DECREF(uid);
                return NULL;
            }
        }

        /* key = f"{namespace}/{name}" */
        PyObject *ns = PyObject_GetAttr(task, s_namespace);  /* new */
        PyObject *nm = ns ? PyObject_GetAttr(task, s_name) : NULL;
        PyObject *key = nm ? PyUnicode_FromFormat("%U/%U", ns, nm) : NULL;
        Py_XDECREF(ns);
        Py_XDECREF(nm);
        if (key == NULL) {
            Py_DECREF(uid);
            return NULL;
        }

        PyObject *node = PyDict_GetItemWithError(ssn_nodes, host); /* borrowed */
        if (node == NULL) {
            /* match the Python oracle exactly: ssn_nodes[host] raises on a
             * missing node — a broken invariant must fail loudly, not bind
             * a pod with silently-wrong session accounting */
            if (!PyErr_Occurred())
                PyErr_SetObject(PyExc_KeyError, host);
            goto fail;
        }
        {
            PyObject *tasks = PyObject_GetAttr(node, s_tasks);   /* new */
            if (tasks == NULL)
                goto fail;
            int rc = PyDict_SetItem(tasks, key, task);
            Py_DECREF(tasks);
            if (rc < 0)
                goto fail;
        }

        if (have_c) {
            PyObject *ctask = PyDict_GetItemWithError(c_tasks, uid); /* borrowed */
            if (ctask == NULL && PyErr_Occurred())
                goto fail;
            if (ctask != NULL) {
                if (PyObject_SetAttr(ctask, s_node_name, host) < 0)
                    goto fail;
                if (PyObject_SetAttr(ctask, s_status, binding) < 0)
                    goto fail;
                if (have_c_pending) {
                    if (PyDict_DelItem(c_pending, uid) < 0) {
                        if (!PyErr_ExceptionMatches(PyExc_KeyError))
                            goto fail;      /* see s_pending DelItem above */
                        PyErr_Clear();
                    }
                    if (PyDict_SetItem(c_binding, uid, ctask) < 0)
                        goto fail;
                }
                if (have_cache_nodes) {
                    PyObject *cnode =
                        PyDict_GetItemWithError(cache_nodes, host); /* borrowed */
                    if (cnode == NULL && PyErr_Occurred())
                        goto fail;
                    if (cnode != NULL) {
                        PyObject *ctasks = PyObject_GetAttr(cnode, s_tasks);
                        if (ctasks == NULL)
                            goto fail;
                        int rc = PyDict_SetItem(ctasks, key, task);
                        Py_DECREF(ctasks);
                        if (rc < 0)
                            goto fail;
                    }
                }
            }
        }

        if (PyList_Append(bind_tasks, task) < 0)
            goto fail;
        {
            PyObject *pod = PyObject_GetAttr(task, s_pod);    /* new */
            if (pod == NULL)
                goto fail;
            int rc = PyList_Append(bind_pods, pod);
            Py_DECREF(pod);
            if (rc < 0)
                goto fail;
        }
        if (PyList_Append(bind_hosts, host) < 0)
            goto fail;

        Py_DECREF(uid);
        Py_DECREF(key);
        continue;
    fail:
        Py_DECREF(uid);
        Py_DECREF(key);
        return NULL;
    }
    Py_RETURN_NONE;
}

/* ------------------------------------------------------------------ */
/* whole-session batched writeback                                     */
/* ------------------------------------------------------------------ */

/* res.milli_cpu += sign*vec[0]; res.memory += sign*vec[1];
 * res.add_scalar(name, sign*vec[2+si]) for nonzero scalar deltas.
 * Mirrors ops/solver.py::_apply_bulk.apply_delta exactly. */
static int
res_add_vec(PyObject *res, const double *vec, Py_ssize_t R,
            PyObject *scalar_names, double sign)
{
    static PyObject *s_milli_cpu, *s_memory, *s_add_scalar;
    if (s_milli_cpu == NULL) {
        s_milli_cpu = PyUnicode_InternFromString("milli_cpu");
        s_memory = PyUnicode_InternFromString("memory");
        s_add_scalar = PyUnicode_InternFromString("add_scalar");
        if (!s_milli_cpu || !s_memory || !s_add_scalar)
            return -1;
    }
    PyObject *names[2] = {s_milli_cpu, s_memory};
    for (int d = 0; d < 2; d++) {
        PyObject *v = PyObject_GetAttr(res, names[d]);
        if (v == NULL)
            return -1;
        double cur = PyFloat_AsDouble(v);
        Py_DECREF(v);
        if (cur == -1.0 && PyErr_Occurred())
            return -1;
        PyObject *nv = PyFloat_FromDouble(cur + sign * vec[d]);
        if (nv == NULL)
            return -1;
        int rc = PyObject_SetAttr(res, names[d], nv);
        Py_DECREF(nv);
        if (rc < 0)
            return -1;
    }
    for (Py_ssize_t si = 0; si + 2 < R; si++) {
        double q = vec[2 + si];
        if (q == 0.0)
            continue;
        PyObject *name = PyTuple_GET_ITEM(scalar_names, si); /* borrowed */
        PyObject *qv = PyFloat_FromDouble(sign * q);
        if (qv == NULL)
            return -1;
        PyObject *r = PyObject_CallMethodObjArgs(res, s_add_scalar,
                                                 name, qv, NULL);
        Py_DECREF(qv);
        if (r == NULL)
            return -1;
        Py_DECREF(r);
    }
    return 0;
}

/* obj.<name> += 1 for integer version/generation counters */
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

#define bump_version(job) bump_int_attr((job), s_status_version)

/* dict.pop(uid, None) where only absence is swallowed */
static int
dict_pop_ignore_missing(PyObject *d, PyObject *k)
{
    if (PyDict_DelItem(d, k) < 0) {
        if (!PyErr_ExceptionMatches(PyExc_KeyError))
            return -1;
        PyErr_Clear();
    }
    return 0;
}

/* contiguous int64 / float64 buffer views */
static int
get_i64(PyObject *obj, Py_buffer *buf, const char *what)
{
    if (PyObject_GetBuffer(obj, buf, PyBUF_CONTIG_RO) < 0)
        return -1;
    if (buf->itemsize != 8) {
        PyBuffer_Release(buf);
        PyErr_Format(PyExc_TypeError, "%s: expected int64 buffer", what);
        return -1;
    }
    return 0;
}

/* apply_all_jobs(job_nz, seg_ends, placed, assign, task_infos, node_names,
 *                ssn_nodes, cache_nodes, job_infos, cache_jobs,
 *                pending, binding, job_sums, scalar_names,
 *                bind_tasks, bind_pods, bind_hosts, bind_keys)
 *
 * Whole-session equivalent of the per-job Python wrapper around
 * apply_job_tasks in ops/solver.py::_apply_bulk: per-job status-index
 * surgery (wholesale PENDING->BINDING bucket move when the entire bucket
 * placed), cache-job mirror updates, per-task attribute/bucket/node-map
 * writes, allocated-resource deltas — one call for the whole assignment.
 *
 * job_nz/seg_ends: int64 buffers (jobs with placements / prefix ends into
 * placed). placed: int64 task indices, job-major contiguous. assign: int64
 * node id per task index. job_sums: float64 [J, R] per-job placed
 * resource sums. cache_jobs: uid -> cache JobInfo dict (or None).
 * bind_keys receives the "ns/name" key per placement (reused by the
 * binder/event batch paths so they need no 50k re-derivations). */
static PyObject *
apply_all_jobs(PyObject *self, PyObject *args)
{
    PyObject *job_nz_o, *seg_ends_o, *placed_o, *assign_o;
    PyObject *task_infos, *node_names, *ssn_nodes, *cache_nodes;
    PyObject *job_infos, *cache_jobs, *pending, *binding;
    PyObject *job_sums_o, *scalar_names;
    PyObject *bind_tasks, *bind_pods, *bind_hosts, *bind_keys;
    /* want_pods=0 skips the per-task .pod extraction into bind_pods — a
     * keyed binder that does not consume pod objects (the k8s Bind
     * subresource needs only name + target) saves one getattr + append
     * per placement */
    int want_pods = 1;

    if (!PyArg_ParseTuple(args, "OOOOOOOOOOOOOOOOOO|i",
                          &job_nz_o, &seg_ends_o, &placed_o, &assign_o,
                          &task_infos, &node_names, &ssn_nodes, &cache_nodes,
                          &job_infos, &cache_jobs, &pending, &binding,
                          &job_sums_o, &scalar_names,
                          &bind_tasks, &bind_pods, &bind_hosts, &bind_keys,
                          &want_pods))
        return NULL;

    int have_cache_nodes = cache_nodes != Py_None;
    int have_cache_jobs = cache_jobs != Py_None;

    Py_buffer job_nz_b = {0}, seg_ends_b = {0}, placed_b = {0},
              assign_b = {0}, sums_b = {0};
    PyObject **ntasks = NULL, **ctasks_n = NULL;
    char *cresolved = NULL;
    PyObject *ret = NULL;

    if (get_i64(job_nz_o, &job_nz_b, "job_nz") < 0)
        return NULL;
    if (get_i64(seg_ends_o, &seg_ends_b, "seg_ends") < 0)
        goto done;
    if (get_i64(placed_o, &placed_b, "placed") < 0)
        goto done;
    if (get_i64(assign_o, &assign_b, "assign") < 0)
        goto done;
    if (PyObject_GetBuffer(job_sums_o, &sums_b, PyBUF_CONTIG_RO) < 0)
        goto done;
    if (sums_b.itemsize != 8) {
        PyErr_SetString(PyExc_TypeError, "job_sums: expected float64 buffer");
        goto done;
    }

    const int64_t *job_nz = (const int64_t *)job_nz_b.buf;
    const int64_t *seg_ends = (const int64_t *)seg_ends_b.buf;
    const int64_t *placed = (const int64_t *)placed_b.buf;
    const int64_t *assign = (const int64_t *)assign_b.buf;
    const double *sums = (const double *)sums_b.buf;
    Py_ssize_t n_jobs_nz = job_nz_b.len / 8;
    Py_ssize_t R = sums_b.len ? (sums_b.ndim == 2 ? sums_b.shape[1]
                                                  : sums_b.len / 8) : 0;
    Py_ssize_t n_nodes = PyList_GET_SIZE(node_names);

    /* lazily-resolved per-node task dicts (strong refs) */
    ntasks = PyMem_Calloc(n_nodes ? n_nodes : 1, sizeof(PyObject *));
    ctasks_n = PyMem_Calloc(n_nodes ? n_nodes : 1, sizeof(PyObject *));
    cresolved = PyMem_Calloc(n_nodes ? n_nodes : 1, 1);
    if (!ntasks || !ctasks_n || !cresolved) {
        PyErr_NoMemory();
        goto done;
    }

    int64_t lo = 0;
    for (Py_ssize_t jj = 0; jj < n_jobs_nz; jj++) {
        int64_t ji = job_nz[jj];
        int64_t hi = seg_ends[jj];
        Py_ssize_t seg_len = (Py_ssize_t)(hi - lo);
        PyObject *job = PyList_GET_ITEM(job_infos, ji);      /* borrowed */

        if (bump_version(job) < 0)
            goto done;
        PyObject *idx = PyObject_GetAttr(job, s_task_status_index); /* new */
        if (idx == NULL)
            goto done;
        PyObject *s_pend = PyDict_GetItemWithError(idx, pending); /* borrowed */
        if (s_pend == NULL && PyErr_Occurred()) {
            Py_DECREF(idx);
            goto done;
        }
        PyObject *s_bind;                                    /* borrowed */
        int s_pend_active = 0;
        if (s_pend != NULL && PyDict_GET_SIZE(s_pend) == seg_len) {
            /* wholesale bucket move: every PENDING task placed */
            s_bind = PyDict_GetItemWithError(idx, binding);
            if (s_bind == NULL) {
                if (PyErr_Occurred()) {
                    Py_DECREF(idx);
                    goto done;
                }
                if (PyDict_SetItem(idx, binding, s_pend) < 0) {
                    Py_DECREF(idx);
                    goto done;
                }
                s_bind = s_pend;
            } else if (PyDict_Merge(s_bind, s_pend, 1) < 0) {
                Py_DECREF(idx);
                goto done;
            }
            if (PyDict_DelItem(idx, pending) < 0) {
                Py_DECREF(idx);
                goto done;
            }
        } else {
            s_pend_active = s_pend != NULL;
            s_bind = PyDict_GetItemWithError(idx, binding);
            if (s_bind == NULL) {
                if (PyErr_Occurred()) {
                    Py_DECREF(idx);
                    goto done;
                }
                PyObject *fresh = PyDict_New();
                if (fresh == NULL ||
                    PyDict_SetItem(idx, binding, fresh) < 0) {
                    Py_XDECREF(fresh);
                    Py_DECREF(idx);
                    goto done;
                }
                s_bind = fresh;
                Py_DECREF(fresh); /* idx holds it */
            }
        }
        Py_DECREF(idx);

        /* cache-job mirror */
        PyObject *cache_job = NULL;                          /* borrowed */
        PyObject *c_tasks = NULL;                            /* new */
        PyObject *c_pend = NULL, *c_bind = NULL;             /* borrowed */
        int c_pend_active = 0;
        if (have_cache_jobs) {
            PyObject *juid = PyObject_GetAttr(job, s_uid);   /* new */
            if (juid == NULL)
                goto done;
            cache_job = PyDict_GetItemWithError(cache_jobs, juid);
            Py_DECREF(juid);
            if (cache_job == NULL && PyErr_Occurred())
                goto done;
        }
        if (cache_job != NULL) {
            if (bump_version(cache_job) < 0)
                goto done;
            c_tasks = PyObject_GetAttr(cache_job, s_tasks);
            if (c_tasks == NULL)
                goto done;
            PyObject *cidx = PyObject_GetAttr(cache_job, s_task_status_index);
            if (cidx == NULL)
                goto job_fail;
            c_pend = PyDict_GetItemWithError(cidx, pending);
            if (c_pend == NULL && PyErr_Occurred()) {
                Py_DECREF(cidx);
                goto job_fail;
            }
            if (c_pend != NULL && PyDict_GET_SIZE(c_pend) == seg_len) {
                c_bind = PyDict_GetItemWithError(cidx, binding);
                if (c_bind == NULL) {
                    if (PyErr_Occurred()) {
                        Py_DECREF(cidx);
                        goto job_fail;
                    }
                    if (PyDict_SetItem(cidx, binding, c_pend) < 0) {
                        Py_DECREF(cidx);
                        goto job_fail;
                    }
                    c_bind = c_pend;
                } else if (PyDict_Merge(c_bind, c_pend, 1) < 0) {
                    Py_DECREF(cidx);
                    goto job_fail;
                }
                if (PyDict_DelItem(cidx, pending) < 0) {
                    Py_DECREF(cidx);
                    goto job_fail;
                }
            } else {
                c_pend_active = c_pend != NULL;
                c_bind = PyDict_GetItemWithError(cidx, binding);
                if (c_bind == NULL) {
                    if (PyErr_Occurred()) {
                        Py_DECREF(cidx);
                        goto job_fail;
                    }
                    PyObject *fresh = PyDict_New();
                    if (fresh == NULL ||
                        PyDict_SetItem(cidx, binding, fresh) < 0) {
                        Py_XDECREF(fresh);
                        Py_DECREF(cidx);
                        goto job_fail;
                    }
                    c_bind = fresh;
                    Py_DECREF(fresh);
                }
            }
            Py_DECREF(cidx);
        }

        /* per-task writeback */
        for (int64_t k = lo; k < hi; k++) {
            int64_t ti = placed[k];
            int64_t ni = assign[ti];
            PyObject *task = PyList_GET_ITEM(task_infos, ti); /* borrowed */
            PyObject *host = PyList_GET_ITEM(node_names, ni); /* borrowed */

            if (PyObject_SetAttr(task, s_node_name, host) < 0)
                goto job_fail;
            if (PyObject_SetAttr(task, s_status, binding) < 0)
                goto job_fail;

            PyObject *uid = PyObject_GetAttr(task, s_uid);   /* new */
            if (uid == NULL)
                goto job_fail;
            if (s_pend_active) {
                if (dict_pop_ignore_missing(s_pend, uid) < 0 ||
                    PyDict_SetItem(s_bind, uid, task) < 0) {
                    Py_DECREF(uid);
                    goto job_fail;
                }
            }

            PyObject *key = PyObject_GetAttr(task, s_key); /* precomputed */
            if (key == NULL) {
                Py_DECREF(uid);
                goto job_fail;
            }

            /* session node task-map (lazy dict resolve per node); the
             * resolve also bumps the node's accounting generation ONCE —
             * any touched node invalidates the snapshot node-axis capture */
            if (ntasks[ni] == NULL) {
                PyObject *node = PyDict_GetItemWithError(ssn_nodes, host);
                if (node == NULL) {
                    if (!PyErr_Occurred())
                        PyErr_SetObject(PyExc_KeyError, host);
                    goto task_fail;
                }
                if (bump_int_attr(node, s_acct_gen) < 0)
                    goto task_fail;
                ntasks[ni] = PyObject_GetAttr(node, s_tasks); /* strong */
                if (ntasks[ni] == NULL)
                    goto task_fail;
            }
            if (PyDict_SetItem(ntasks[ni], key, task) < 0)
                goto task_fail;

            if (c_tasks != NULL) {
                PyObject *ctask = PyDict_GetItemWithError(c_tasks, uid);
                if (ctask == NULL && PyErr_Occurred())
                    goto task_fail;
                if (ctask != NULL) {
                    if (PyObject_SetAttr(ctask, s_node_name, host) < 0)
                        goto task_fail;
                    if (PyObject_SetAttr(ctask, s_status, binding) < 0)
                        goto task_fail;
                    if (c_pend_active) {
                        if (dict_pop_ignore_missing(c_pend, uid) < 0 ||
                            PyDict_SetItem(c_bind, uid, ctask) < 0)
                            goto task_fail;
                    }
                    if (have_cache_nodes) {
                        if (!cresolved[ni]) {
                            cresolved[ni] = 1;
                            PyObject *cnode =
                                PyDict_GetItemWithError(cache_nodes, host);
                            if (cnode == NULL && PyErr_Occurred())
                                goto task_fail;
                            if (cnode != NULL) {
                                if (bump_int_attr(cnode, s_acct_gen) < 0)
                                    goto task_fail;
                                ctasks_n[ni] =
                                    PyObject_GetAttr(cnode, s_tasks);
                                if (ctasks_n[ni] == NULL)
                                    goto task_fail;
                            }
                        }
                        if (ctasks_n[ni] != NULL &&
                            PyDict_SetItem(ctasks_n[ni], key, task) < 0)
                            goto task_fail;
                    }
                }
            }

            if (PyList_Append(bind_tasks, task) < 0)
                goto task_fail;
            if (want_pods) {
                PyObject *pod = PyObject_GetAttr(task, s_pod);
                if (pod == NULL)
                    goto task_fail;
                int rc = PyList_Append(bind_pods, pod);
                Py_DECREF(pod);
                if (rc < 0)
                    goto task_fail;
            }
            if (PyList_Append(bind_hosts, host) < 0 ||
                PyList_Append(bind_keys, key) < 0)
                goto task_fail;

            Py_DECREF(uid);
            Py_DECREF(key);
            continue;
        task_fail:
            Py_DECREF(uid);
            Py_XDECREF(key);
            goto job_fail;
        }

        /* PENDING -> BINDING leaves total_request unchanged; allocated
         * grows by the job's placed sum (both trees) */
        {
            const double *vec = sums + ji * R;
            PyObject *alloc = PyObject_GetAttr(job, s_allocated);
            if (alloc == NULL)
                goto job_fail;
            int rc = res_add_vec(alloc, vec, R, scalar_names, 1.0);
            Py_DECREF(alloc);
            if (rc < 0)
                goto job_fail;
            /* every placed task left the PENDING bucket: the
             * incrementally-maintained pending request sum shrinks by
             * the same vector (job_info.py pending_sum) */
            alloc = PyObject_GetAttr(job, s_pending_sum);
            if (alloc == NULL)
                goto job_fail;
            rc = res_add_vec(alloc, vec, R, scalar_names, -1.0);
            Py_DECREF(alloc);
            if (rc < 0)
                goto job_fail;
            if (cache_job != NULL) {
                alloc = PyObject_GetAttr(cache_job, s_allocated);
                if (alloc == NULL)
                    goto job_fail;
                rc = res_add_vec(alloc, vec, R, scalar_names, 1.0);
                Py_DECREF(alloc);
                if (rc < 0)
                    goto job_fail;
                alloc = PyObject_GetAttr(cache_job, s_pending_sum);
                if (alloc == NULL)
                    goto job_fail;
                rc = res_add_vec(alloc, vec, R, scalar_names, -1.0);
                Py_DECREF(alloc);
                if (rc < 0)
                    goto job_fail;
            }
        }

        Py_XDECREF(c_tasks);
        lo = hi;
        continue;
    job_fail:
        Py_XDECREF(c_tasks);
        goto done;
    }

    ret = Py_None;
    Py_INCREF(ret);
done:
    if (ntasks) {
        for (Py_ssize_t i = 0; i < n_nodes; i++)
            Py_XDECREF(ntasks[i]);
        PyMem_Free(ntasks);
    }
    if (ctasks_n) {
        for (Py_ssize_t i = 0; i < n_nodes; i++)
            Py_XDECREF(ctasks_n[i]);
        PyMem_Free(ctasks_n);
    }
    PyMem_Free(cresolved);
    if (job_nz_b.obj)
        PyBuffer_Release(&job_nz_b);
    if (seg_ends_b.obj)
        PyBuffer_Release(&seg_ends_b);
    if (placed_b.obj)
        PyBuffer_Release(&placed_b);
    if (assign_b.obj)
        PyBuffer_Release(&assign_b);
    if (sums_b.obj)
        PyBuffer_Release(&sums_b);
    return ret;
}

/* apply_node_deltas(nz, sums, node_names, ssn_nodes, cache_nodes,
 *                   scalar_names)
 *
 * Bulk node accounting: for each touched node index in nz (int64 buffer),
 * idle -= vec and used += vec on the session NodeInfo and the cache
 * mirror (when present). sums: float64 [N, R]. Same semantics as the
 * Python loop in _apply_bulk's post section. */
static PyObject *
apply_node_deltas(PyObject *self, PyObject *args)
{
    PyObject *nz_o, *sums_o, *node_names, *ssn_nodes, *cache_nodes;
    PyObject *scalar_names;
    if (!PyArg_ParseTuple(args, "OOOOOO", &nz_o, &sums_o, &node_names,
                          &ssn_nodes, &cache_nodes, &scalar_names))
        return NULL;

    static PyObject *s_idle, *s_used;
    if (s_idle == NULL) {
        s_idle = PyUnicode_InternFromString("idle");
        s_used = PyUnicode_InternFromString("used");
        if (!s_idle || !s_used)
            return NULL;
    }

    Py_buffer nz_b = {0}, sums_b = {0};
    PyObject *ret = NULL;
    if (get_i64(nz_o, &nz_b, "nz") < 0)
        return NULL;
    if (PyObject_GetBuffer(sums_o, &sums_b, PyBUF_CONTIG_RO) < 0)
        goto done;
    if (sums_b.itemsize != 8) {
        PyErr_SetString(PyExc_TypeError, "sums: expected float64 buffer");
        goto done;
    }
    const int64_t *nz = (const int64_t *)nz_b.buf;
    const double *sums = (const double *)sums_b.buf;
    Py_ssize_t count = nz_b.len / 8;
    Py_ssize_t R = sums_b.ndim == 2 ? sums_b.shape[1] : 0;
    if (R == 0) {
        PyErr_SetString(PyExc_TypeError, "sums: expected [N, R] array");
        goto done;
    }
    int have_cache = cache_nodes != Py_None;

    for (Py_ssize_t i = 0; i < count; i++) {
        int64_t ni = nz[i];
        const double *vec = sums + ni * R;
        PyObject *name = PyList_GET_ITEM(node_names, ni);    /* borrowed */
        for (int tree = 0; tree < 2; tree++) {
            PyObject *src = tree == 0 ? ssn_nodes : cache_nodes;
            if (tree == 1 && !have_cache)
                break;
            PyObject *node = PyDict_GetItemWithError(src, name);
            if (node == NULL) {
                if (PyErr_Occurred())
                    goto done;
                continue;
            }
            if (bump_int_attr(node, s_acct_gen) < 0)
                goto done;
            PyObject *idle = PyObject_GetAttr(node, s_idle);
            if (idle == NULL)
                goto done;
            int rc = res_add_vec(idle, vec, R, scalar_names, -1.0);
            Py_DECREF(idle);
            if (rc < 0)
                goto done;
            PyObject *used = PyObject_GetAttr(node, s_used);
            if (used == NULL)
                goto done;
            rc = res_add_vec(used, vec, R, scalar_names, 1.0);
            Py_DECREF(used);
            if (rc < 0)
                goto done;
        }
    }
    ret = Py_None;
    Py_INCREF(ret);
done:
    if (nz_b.obj)
        PyBuffer_Release(&nz_b);
    if (sums_b.obj)
        PyBuffer_Release(&sums_b);
    return ret;
}

/* update_drf_shares(job_nz, sums, attrs, total_names, total_vals,
 *                   scalar_names)
 *
 * Per placed job: attr.allocated += sums[ji]; then recompute the DRF
 * dominant share exactly like drf._update_share / share_helpers.share
 * (r == 0 -> 0 if l == 0 else 1; strictly-greater keeps the FIRST
 * dominant dimension on ties). attrs is aligned with job_nz and may hold
 * None for jobs without a DRF attr. total_names[0:2] must be
 * ("cpu", "memory"); later entries are scalar resource names looked up in
 * allocated.scalar_resources. */
static PyObject *
update_drf_shares(PyObject *self, PyObject *args)
{
    PyObject *job_nz_o, *sums_o, *attrs, *total_names, *total_vals_o;
    PyObject *scalar_names;
    if (!PyArg_ParseTuple(args, "OOOOOO", &job_nz_o, &sums_o, &attrs,
                          &total_names, &total_vals_o, &scalar_names))
        return NULL;

    static PyObject *s_alloc_attr, *s_share, *s_dominant, *s_milli_cpu2,
        *s_memory2, *s_scalar_resources, *s_empty;
    if (s_alloc_attr == NULL) {
        s_alloc_attr = PyUnicode_InternFromString("allocated");
        s_share = PyUnicode_InternFromString("share");
        s_dominant = PyUnicode_InternFromString("dominant_resource");
        s_milli_cpu2 = PyUnicode_InternFromString("milli_cpu");
        s_memory2 = PyUnicode_InternFromString("memory");
        s_scalar_resources = PyUnicode_InternFromString("scalar_resources");
        s_empty = PyUnicode_InternFromString("");
        if (!s_alloc_attr || !s_share || !s_dominant || !s_milli_cpu2 ||
            !s_memory2 || !s_scalar_resources || !s_empty)
            return NULL;
    }

    Py_buffer nz_b = {0}, sums_b = {0}, tv_b = {0};
    PyObject *ret = NULL;
    if (get_i64(job_nz_o, &nz_b, "job_nz") < 0)
        return NULL;
    if (PyObject_GetBuffer(sums_o, &sums_b, PyBUF_CONTIG_RO) < 0)
        goto done;
    if (PyObject_GetBuffer(total_vals_o, &tv_b, PyBUF_CONTIG_RO) < 0)
        goto done;
    if (sums_b.itemsize != 8 || tv_b.itemsize != 8) {
        PyErr_SetString(PyExc_TypeError, "expected float64 buffers");
        goto done;
    }
    const int64_t *nz = (const int64_t *)nz_b.buf;
    const double *sums = (const double *)sums_b.buf;
    const double *tvals = (const double *)tv_b.buf;
    Py_ssize_t count = nz_b.len / 8;
    Py_ssize_t R = sums_b.ndim == 2 ? sums_b.shape[1] : 0;
    Py_ssize_t D = PyTuple_GET_SIZE(total_names);
    if (R == 0) {
        PyErr_SetString(PyExc_TypeError, "sums: expected [J, R] array");
        goto done;
    }

    for (Py_ssize_t i = 0; i < count; i++) {
        PyObject *attr = PyList_GET_ITEM(attrs, i);          /* borrowed */
        if (attr == Py_None)
            continue;
        int64_t ji = nz[i];
        const double *vec = sums + ji * R;
        PyObject *alloc = PyObject_GetAttr(attr, s_alloc_attr); /* new */
        if (alloc == NULL)
            goto done;
        if (res_add_vec(alloc, vec, R, scalar_names, 1.0) < 0) {
            Py_DECREF(alloc);
            goto done;
        }
        /* dominant share over the cluster total's dimensions */
        double best = 0.0;
        PyObject *dom = s_empty;                             /* borrowed */
        PyObject *scalars = NULL;                            /* new */
        int fail = 0;
        for (Py_ssize_t d = 0; d < D; d++) {
            double av;
            if (d < 2) {
                PyObject *v = PyObject_GetAttr(
                    alloc, d == 0 ? s_milli_cpu2 : s_memory2);
                if (v == NULL) { fail = 1; break; }
                av = PyFloat_AsDouble(v);
                Py_DECREF(v);
                if (av == -1.0 && PyErr_Occurred()) { fail = 1; break; }
            } else {
                if (scalars == NULL) {
                    scalars = PyObject_GetAttr(alloc, s_scalar_resources);
                    if (scalars == NULL) { fail = 1; break; }
                }
                av = 0.0;
                if (scalars != Py_None) {
                    PyObject *q = PyDict_GetItemWithError(
                        scalars, PyTuple_GET_ITEM(total_names, d));
                    if (q == NULL && PyErr_Occurred()) { fail = 1; break; }
                    if (q != NULL) {
                        av = PyFloat_AsDouble(q);
                        if (av == -1.0 && PyErr_Occurred()) {
                            fail = 1;
                            break;
                        }
                    }
                }
            }
            double tv = tvals[d];
            double s = tv == 0.0 ? (av == 0.0 ? 0.0 : 1.0) : av / tv;
            if (s > best) {
                best = s;
                dom = PyTuple_GET_ITEM(total_names, d);
            }
        }
        Py_XDECREF(scalars);
        Py_DECREF(alloc);
        if (fail)
            goto done;
        PyObject *bv = PyFloat_FromDouble(best);
        if (bv == NULL)
            goto done;
        int rc = PyObject_SetAttr(attr, s_share, bv);
        Py_DECREF(bv);
        if (rc < 0 || PyObject_SetAttr(attr, s_dominant, dom) < 0)
            goto done;
    }
    ret = Py_None;
    Py_INCREF(ret);
done:
    if (nz_b.obj)
        PyBuffer_Release(&nz_b);
    if (sums_b.obj)
        PyBuffer_Release(&sums_b);
    if (tv_b.obj)
        PyBuffer_Release(&tv_b);
    return ret;
}

/* mirror_all_jobs(job_nz, seg_ends, placed, assign, task_infos,
 *                 node_names, cache_nodes, job_infos, cache_jobs,
 *                 pending, binding, job_sums, scalar_names)
 *
 * The CACHE half of apply_all_jobs, for the deferred mirror flush
 * (scheduler/cache/cache.py flush_mirror): per cache-job status flips,
 * bucket moves, session-task inserts into cache node maps, and
 * allocated/pending_sum deltas. Unlike the session side, the cache may
 * have CHURNED in the defer window (watch events delete/re-status
 * tasks), so there is NO wholesale bucket-move fast path and every move
 * pops from the task's ACTUAL current bucket with update_task_status's
 * boundary rules (alloc_mask gates the allocated add; only tasks leaving
 * PENDING shrink pending_sum) — identical to the Python fallback loop,
 * which stays as the oracle. Caller holds the cache lock.
 *
 * Returns the list of SKIPPED placed-positions (indices into `placed`):
 * placements whose cache twin vanished in the defer window (task deleted,
 * or the whole job gone). The caller excludes exactly these from the node
 * idle/used deltas so cache accounting stays per-flipped-task. */
static int
append_idx(PyObject *list, int64_t k)
{
    PyObject *o = PyLong_FromLongLong((long long)k);
    if (o == NULL)
        return -1;
    int rc = PyList_Append(list, o);
    Py_DECREF(o);
    return rc;
}

static PyObject *
mirror_all_jobs(PyObject *self, PyObject *args)
{
    PyObject *job_nz_o, *seg_ends_o, *placed_o, *assign_o;
    PyObject *task_infos, *node_names, *cache_nodes;
    PyObject *job_infos, *cache_jobs, *pending, *binding;
    PyObject *job_sums_o, *scalar_names;
    long alloc_mask;

    if (!PyArg_ParseTuple(args, "OOOOOOOOOOOOOl",
                          &job_nz_o, &seg_ends_o, &placed_o, &assign_o,
                          &task_infos, &node_names, &cache_nodes,
                          &job_infos, &cache_jobs, &pending, &binding,
                          &job_sums_o, &scalar_names, &alloc_mask))
        return NULL;

    Py_buffer job_nz_b = {0}, seg_ends_b = {0}, placed_b = {0},
              assign_b = {0}, sums_b = {0};
    PyObject **ctasks_n = NULL;
    char *cresolved = NULL;
    PyObject *ret = NULL;
    PyObject *skipped = PyList_New(0);

    if (skipped == NULL)
        return NULL;
    if (get_i64(job_nz_o, &job_nz_b, "job_nz") < 0) {
        Py_DECREF(skipped);
        return NULL;
    }
    if (get_i64(seg_ends_o, &seg_ends_b, "seg_ends") < 0)
        goto done;
    if (get_i64(placed_o, &placed_b, "placed") < 0)
        goto done;
    if (get_i64(assign_o, &assign_b, "assign") < 0)
        goto done;
    if (PyObject_GetBuffer(job_sums_o, &sums_b, PyBUF_CONTIG_RO) < 0)
        goto done;
    if (sums_b.itemsize != 8) {
        PyErr_SetString(PyExc_TypeError, "job_sums: expected float64 buffer");
        goto done;
    }

    const int64_t *job_nz = (const int64_t *)job_nz_b.buf;
    const int64_t *seg_ends = (const int64_t *)seg_ends_b.buf;
    const int64_t *placed = (const int64_t *)placed_b.buf;
    const int64_t *assign = (const int64_t *)assign_b.buf;
    const double *sums = (const double *)sums_b.buf;
    Py_ssize_t n_jobs_nz = job_nz_b.len / 8;
    Py_ssize_t R = sums_b.len ? (sums_b.ndim == 2 ? sums_b.shape[1]
                                                  : sums_b.len / 8) : 0;
    Py_ssize_t n_nodes = PyList_GET_SIZE(node_names);

    ctasks_n = PyMem_Calloc(n_nodes ? n_nodes : 1, sizeof(PyObject *));
    cresolved = PyMem_Calloc(n_nodes ? n_nodes : 1, 1);
    if (!ctasks_n || !cresolved) {
        PyErr_NoMemory();
        goto done;
    }

    int64_t lo = 0;
    for (Py_ssize_t jj = 0; jj < n_jobs_nz; jj++) {
        int64_t ji = job_nz[jj];
        int64_t hi = seg_ends[jj];
        Py_ssize_t seg_len = (Py_ssize_t)(hi - lo);
        PyObject *job = PyList_GET_ITEM(job_infos, ji);      /* borrowed */

        PyObject *juid = PyObject_GetAttr(job, s_uid);       /* new */
        if (juid == NULL)
            goto done;
        PyObject *cache_job = PyDict_GetItemWithError(cache_jobs, juid);
        Py_DECREF(juid);
        if (cache_job == NULL) {
            if (PyErr_Occurred())
                goto done;
            for (int64_t k = lo; k < hi; k++)
                if (append_idx(skipped, k) < 0)
                    goto done;
            lo = hi;  /* job no longer in the cache: skip its segment */
            continue;
        }

        if (bump_version(cache_job) < 0)
            goto done;
        PyObject *c_tasks = PyObject_GetAttr(cache_job, s_tasks); /* new */
        if (c_tasks == NULL)
            goto done;
        PyObject *cidx = PyObject_GetAttr(cache_job, s_task_status_index);
        if (cidx == NULL)
            goto job_fail2;

        /* per-flipped-task accounting accumulators (R <= 64 scalars is
         * far beyond any real session; larger R falls back by erroring
         * out to the Python oracle) */
        double vec_alloc[64], vec_pend[64];
        if (R > 64) {
            PyErr_SetString(PyExc_ValueError, "mirror_all_jobs: R > 64");
            goto job_fail;
        }
        for (Py_ssize_t r = 0; r < R; r++)
            vec_alloc[r] = vec_pend[r] = 0.0;

        for (int64_t k = lo; k < hi; k++) {
            int64_t ti = placed[k];
            int64_t ni = assign[ti];
            PyObject *task = PyList_GET_ITEM(task_infos, ti); /* borrowed */
            PyObject *host = PyList_GET_ITEM(node_names, ni); /* borrowed */

            PyObject *uid = PyObject_GetAttr(task, s_uid);   /* new */
            if (uid == NULL)
                goto job_fail;
            PyObject *ctask = PyDict_GetItemWithError(c_tasks, uid);
            if (ctask == NULL) {
                Py_DECREF(uid);
                if (PyErr_Occurred())
                    goto job_fail;
                if (append_idx(skipped, k) < 0)
                    goto job_fail;
                continue;  /* deleted in the defer window: its sums were
                            * settled by delete_task_info already */
            }

            /* pop from the task's ACTUAL current bucket (it may have
             * been re-statused by a watch event since the session ran),
             * deleting the bucket when it empties — the Python oracle's
             * exact moves */
            PyObject *old_status = PyObject_GetAttr(ctask, s_status);
            if (old_status == NULL) {
                Py_DECREF(uid);
                goto job_fail;
            }
            long old_l = PyLong_AsLong(old_status);
            if (old_l == -1 && PyErr_Occurred()) {
                Py_DECREF(old_status);
                Py_DECREF(uid);
                goto job_fail;
            }
            PyObject *old_bucket = PyDict_GetItemWithError(cidx, old_status);
            if (old_bucket == NULL && PyErr_Occurred()) {
                Py_DECREF(old_status);
                Py_DECREF(uid);
                goto job_fail;
            }
            if (old_bucket != NULL) {
                if (dict_pop_ignore_missing(old_bucket, uid) < 0) {
                    Py_DECREF(old_status);
                    Py_DECREF(uid);
                    goto job_fail;
                }
                if (PyDict_GET_SIZE(old_bucket) == 0 &&
                    PyDict_DelItem(cidx, old_status) < 0) {
                    Py_DECREF(old_status);
                    Py_DECREF(uid);
                    goto job_fail;
                }
            }

            if (PyObject_SetAttr(ctask, s_node_name, host) < 0 ||
                PyObject_SetAttr(ctask, s_status, binding) < 0) {
                Py_DECREF(old_status);
                Py_DECREF(uid);
                goto job_fail;
            }

            /* insert into the BINDING bucket, created lazily (looked up
             * per task: the pop above may have deleted-and-recreated it) */
            {
                PyObject *nb = PyDict_GetItemWithError(cidx, binding);
                if (nb == NULL) {
                    if (PyErr_Occurred()) {
                        Py_DECREF(old_status);
                        Py_DECREF(uid);
                        goto job_fail;
                    }
                    nb = PyDict_New();
                    if (nb == NULL ||
                        PyDict_SetItem(cidx, binding, nb) < 0) {
                        Py_XDECREF(nb);
                        Py_DECREF(old_status);
                        Py_DECREF(uid);
                        goto job_fail;
                    }
                    Py_DECREF(nb);
                    nb = PyDict_GetItemWithError(cidx, binding);
                    if (nb == NULL) {
                        Py_DECREF(old_status);
                        Py_DECREF(uid);
                        goto job_fail;
                    }
                }
                if (PyDict_SetItem(nb, uid, ctask) < 0) {
                    Py_DECREF(old_status);
                    Py_DECREF(uid);
                    goto job_fail;
                }
            }
            Py_DECREF(uid);

            /* boundary-ruled accounting accumulation: BINDING is in the
             * allocated class, so allocated grows only for tasks NOT
             * already allocated-class, and pending_sum shrinks only for
             * tasks leaving PENDING (job_info.update_task_status rules) */
            int was_alloc = (old_l & alloc_mask) != 0;
            int was_pend = old_status == pending;
            if (!was_pend) {
                int eq = PyObject_RichCompareBool(old_status, pending, Py_EQ);
                if (eq < 0) {
                    Py_DECREF(old_status);
                    goto job_fail;
                }
                was_pend = eq;
            }
            Py_DECREF(old_status);
            if (!was_alloc || was_pend) {
                PyObject *req = PyObject_GetAttr(ctask, s_resreq);
                if (req == NULL)
                    goto job_fail;
                PyObject *mc = PyObject_GetAttr(req, s_milli_cpu_g);
                PyObject *mem = mc ? PyObject_GetAttr(req, s_memory_g) : NULL;
                if (mem == NULL) {
                    Py_XDECREF(mc);
                    Py_DECREF(req);
                    goto job_fail;
                }
                double mcv = PyFloat_AsDouble(mc);
                double memv = PyFloat_AsDouble(mem);
                Py_DECREF(mc);
                Py_DECREF(mem);
                if (PyErr_Occurred()) {
                    Py_DECREF(req);
                    goto job_fail;
                }
                if (!was_alloc) { vec_alloc[0] += mcv; vec_alloc[1] += memv; }
                if (was_pend)   { vec_pend[0] += mcv;  vec_pend[1] += memv; }
                PyObject *scal = PyObject_GetAttr(req, s_scalar_res_g);
                Py_DECREF(req);
                if (scal == NULL)
                    goto job_fail;
                if (scal != Py_None && PyDict_GET_SIZE(scal) > 0) {
                    PyObject *sk, *sv;
                    Py_ssize_t pos = 0;
                    while (PyDict_Next(scal, &pos, &sk, &sv)) {
                        double q = PyFloat_AsDouble(sv);
                        if (q == -1.0 && PyErr_Occurred()) {
                            Py_DECREF(scal);
                            goto job_fail;
                        }
                        for (Py_ssize_t r = 2; r < R; r++) {
                            PyObject *rn = PyTuple_GET_ITEM(scalar_names,
                                                            r - 2);
                            int same = PyObject_RichCompareBool(sk, rn,
                                                                Py_EQ);
                            if (same < 0) {
                                Py_DECREF(scal);
                                goto job_fail;
                            }
                            if (same) {
                                if (!was_alloc) vec_alloc[r] += q;
                                if (was_pend)   vec_pend[r] += q;
                                break;
                            }
                        }
                    }
                }
                Py_DECREF(scal);
            }

            /* cache node task-map: the SESSION task object is shared in,
             * exactly as the inline writeback and the Python flush do */
            if (!cresolved[ni]) {
                cresolved[ni] = 1;
                PyObject *cnode = PyDict_GetItemWithError(cache_nodes, host);
                if (cnode == NULL && PyErr_Occurred())
                    goto job_fail;
                if (cnode != NULL) {
                    if (bump_int_attr(cnode, s_acct_gen) < 0)
                        goto job_fail;
                    ctasks_n[ni] = PyObject_GetAttr(cnode, s_tasks);
                    if (ctasks_n[ni] == NULL)
                        goto job_fail;
                }
            }
            if (ctasks_n[ni] != NULL) {
                PyObject *key = PyObject_GetAttr(task, s_key);
                if (key == NULL)
                    goto job_fail;
                int rc = PyDict_SetItem(ctasks_n[ni], key, task);
                Py_DECREF(key);
                if (rc < 0)
                    goto job_fail;
            }
        }

        {
            PyObject *res = PyObject_GetAttr(cache_job, s_allocated);
            if (res == NULL)
                goto job_fail;
            int rc = res_add_vec(res, vec_alloc, R, scalar_names, 1.0);
            Py_DECREF(res);
            if (rc < 0)
                goto job_fail;
            res = PyObject_GetAttr(cache_job, s_pending_sum);
            if (res == NULL)
                goto job_fail;
            rc = res_add_vec(res, vec_pend, R, scalar_names, -1.0);
            Py_DECREF(res);
            if (rc < 0)
                goto job_fail;
        }

        Py_DECREF(cidx);
        Py_DECREF(c_tasks);
        lo = hi;
        continue;
    job_fail:
        Py_DECREF(cidx);
    job_fail2:
        Py_DECREF(c_tasks);
        goto done;
    }

    ret = skipped;
    skipped = NULL;
done:
    Py_XDECREF(skipped);
    if (ctasks_n) {
        for (Py_ssize_t i = 0; i < n_nodes; i++)
            Py_XDECREF(ctasks_n[i]);
        PyMem_Free(ctasks_n);
    }
    PyMem_Free(cresolved);
    if (job_nz_b.obj)
        PyBuffer_Release(&job_nz_b);
    if (seg_ends_b.obj)
        PyBuffer_Release(&seg_ends_b);
    if (placed_b.obj)
        PyBuffer_Release(&placed_b);
    if (assign_b.obj)
        PyBuffer_Release(&assign_b);
    if (sums_b.obj)
        PyBuffer_Release(&sums_b);
    return ret;
}

static PyMethodDef methods[] = {
    {"apply_job_tasks", apply_job_tasks, METH_VARARGS,
     "Native per-task placement writeback for one job segment."},
    {"mirror_all_jobs", mirror_all_jobs, METH_VARARGS,
     "Cache-half of apply_all_jobs for the deferred mirror flush."},
    {"apply_all_jobs", apply_all_jobs, METH_VARARGS,
     "Whole-session batched placement writeback (all jobs, one call)."},
    {"apply_node_deltas", apply_node_deltas, METH_VARARGS,
     "Bulk idle/used node accounting for touched nodes."},
    {"update_drf_shares", update_drf_shares, METH_VARARGS,
     "Batched DRF allocated-delta + dominant-share recompute."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fastapply",
    "Native bulk-apply inner loop (see ops/solver.py::_apply_bulk).",
    -1, methods,
};

PyMODINIT_FUNC
PyInit__fastapply(void)
{
    s_node_name = PyUnicode_InternFromString("node_name");
    s_status = PyUnicode_InternFromString("status");
    s_uid = PyUnicode_InternFromString("uid");
    s_namespace = PyUnicode_InternFromString("namespace");
    s_name = PyUnicode_InternFromString("name");
    s_tasks = PyUnicode_InternFromString("tasks");
    s_pod = PyUnicode_InternFromString("pod");
    s_status_version = PyUnicode_InternFromString("_status_version");
    s_task_status_index = PyUnicode_InternFromString("task_status_index");
    s_allocated = PyUnicode_InternFromString("allocated");
    s_key = PyUnicode_InternFromString("key");
    s_acct_gen = PyUnicode_InternFromString("_acct_gen");
    s_pending_sum = PyUnicode_InternFromString("pending_sum");
    s_resreq = PyUnicode_InternFromString("resreq");
    s_milli_cpu_g = PyUnicode_InternFromString("milli_cpu");
    s_memory_g = PyUnicode_InternFromString("memory");
    s_scalar_res_g = PyUnicode_InternFromString("scalar_resources");
    if (!s_resreq || !s_milli_cpu_g || !s_memory_g || !s_scalar_res_g)
        return NULL;
    if (!s_node_name || !s_status || !s_uid || !s_namespace || !s_name ||
        !s_tasks || !s_pod || !s_status_version || !s_task_status_index ||
        !s_allocated || !s_key || !s_acct_gen || !s_pending_sum)
        return NULL;
    return PyModule_Create(&moduledef);
}
