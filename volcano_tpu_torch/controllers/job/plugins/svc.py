"""svc job plugin: headless-service DNS + hostfile ConfigMap — the
rendezvous fabric for distributed workers
(volcano pkg/controllers/job/plugins/svc/svc.go:54-120).

Each pod gets hostname=podName / subdomain=jobName (stable DNS names), and a
ConfigMap with `<task>.host` entries listing every task replica's DNS name —
exactly what `mpiexec --hostfile /etc/volcano/mpiworker.host` consumes
(reference test/e2e/mpi.go:55).
"""

from __future__ import annotations

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.controllers.job import helpers

CONFIG_MAP_MOUNT_PATH = "/etc/volcano"


def generate_hosts(job: objects.Job) -> dict:
    """`<task>.host` -> newline list of pod DNS names (svc.go generateHost)."""
    data = {}
    for ts in job.spec.tasks:
        hosts = []
        for i in range(ts.replicas):
            pod_name = helpers.make_pod_name(job.metadata.name, ts.name, i)
            hosts.append(f"{pod_name}.{job.metadata.name}")
        data[f"{ts.name}.host"] = "\n".join(hosts)
    return data


class SvcPlugin:
    def __init__(self, store, arguments=None):
        self.store = store
        self.arguments = arguments or []

    def name(self) -> str:
        return "svc"

    def _cm_name(self, job: objects.Job) -> str:
        return f"{job.metadata.name}-svc"

    def on_pod_create(self, pod: objects.Pod, job: objects.Job) -> None:
        if not pod.spec.hostname:
            pod.spec.hostname = pod.metadata.name
        if not pod.spec.subdomain:
            pod.spec.subdomain = job.metadata.name
        cm_name = self._cm_name(job)
        pod.spec.volumes.append(objects.Volume(name=cm_name, config_map=cm_name))
        for container in pod.spec.containers:
            container.volume_mounts.append(objects.VolumeMount(
                name=cm_name, mount_path=CONFIG_MAP_MOUNT_PATH))

    def on_job_add(self, job: objects.Job) -> None:
        if job.status.controlled_resources.get("plugin-svc") == "svc":
            return
        owner = objects.OwnerReference(
            kind=objects.Job.KIND, name=job.metadata.name,
            uid=job.metadata.uid, controller=True)
        cm = objects.ConfigMap(
            metadata=objects.ObjectMeta(
                name=self._cm_name(job), namespace=job.metadata.namespace,
                owner_references=[owner]),
            data=generate_hosts(job),
        )
        if self.store.try_get("ConfigMap", cm.metadata.namespace, cm.metadata.name) is None:
            self.store.create(cm)
        if self.store.try_get("Service", job.metadata.namespace, job.metadata.name) is None:
            self.store.create(objects.Service(
                metadata=objects.ObjectMeta(
                    name=job.metadata.name, namespace=job.metadata.namespace,
                    owner_references=[owner]),
                cluster_ip="None",  # headless
                selector={objects.JOB_NAME_KEY: job.metadata.name},
            ))
        job.status.controlled_resources["plugin-svc"] = "svc"

    def on_job_delete(self, job: objects.Job) -> None:
        self.store.try_delete("ConfigMap", job.metadata.namespace, self._cm_name(job))
        self.store.try_delete("Service", job.metadata.namespace, job.metadata.name)
        job.status.controlled_resources.pop("plugin-svc", None)


def new(store, arguments):
    return SvcPlugin(store, arguments)
