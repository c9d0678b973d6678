"""Naming + pod factory helpers
(volcano pkg/controllers/job/helpers/helpers.go + job_controller_util.go:36-120)."""

from __future__ import annotations

import copy
import random
import string

from volcano_tpu_torch.api import objects

POD_NAME_FMT = "{job}-{task}-{index}"
VOLUME_CLAIM_FMT = "{job}-volume-{rand}"
PERSISTENT_VOLUME_CLAIM_FMT = "{job}-pvc-{rand}"


def make_pod_name(job_name: str, task_name: str, index: int) -> str:
    return POD_NAME_FMT.format(job=job_name, task=task_name, index=index)


def _rand_str(n: int = 12) -> str:
    return "".join(random.choices(string.ascii_lowercase + string.digits, k=n))


def make_volume_claim_name(job_name: str) -> str:
    return VOLUME_CLAIM_FMT.format(job=job_name, rand=_rand_str())


def get_task_index(pod: objects.Pod) -> int:
    """Task index from the pod name suffix (helpers.go GetTaskIndex)."""
    parts = pod.metadata.name.split("-")
    if parts and parts[-1].isdigit():
        return int(parts[-1])
    return -1


def create_job_pod(
    job: objects.Job, template: objects.PodTemplateSpec, index: int
) -> objects.Pod:
    """Pod from a task template: name job-task-idx, volumes from
    Job.Spec.Volumes, annotations TaskSpec/GroupName/JobName/JobVersion,
    labels for the svc plugin (job_controller_util.go:40-120)."""
    task_name = template.name
    pod_name = make_pod_name(job.metadata.name, task_name, index)

    spec = copy.deepcopy(template.spec)
    # mount job volumes into every container
    for volume in job.spec.volumes:
        vc_name = volume.volume_claim_name
        spec.volumes.append(objects.Volume(
            name=vc_name,
            persistent_volume_claim=vc_name if volume.volume_claim else "",
            empty_dir=volume.volume_claim is None,
        ))
        for container in spec.containers:
            container.volume_mounts.append(objects.VolumeMount(
                name=vc_name, mount_path=volume.mount_path))

    metadata = objects.ObjectMeta(
        name=pod_name,
        namespace=job.metadata.namespace,
        labels=dict(template.metadata.labels),
        annotations=dict(template.metadata.annotations),
        owner_references=[objects.OwnerReference(
            kind=objects.Job.KIND,
            name=job.metadata.name,
            uid=job.metadata.uid,
            controller=True,
        )],
    )
    metadata.annotations[objects.TASK_SPEC_KEY] = task_name
    metadata.annotations[objects.GROUP_NAME_ANNOTATION_KEY] = job.metadata.name
    metadata.annotations[objects.JOB_NAME_KEY] = job.metadata.name
    metadata.annotations[objects.JOB_VERSION_KEY] = str(job.status.version)
    metadata.labels[objects.JOB_NAME_KEY] = job.metadata.name
    metadata.labels["volcano.sh/job-namespace"] = job.metadata.namespace

    if job.spec.scheduler_name and not spec.scheduler_name:
        spec.scheduler_name = job.spec.scheduler_name

    pod = objects.Pod(metadata=metadata, spec=spec,
                      status=objects.PodStatus(phase=objects.POD_PHASE_PENDING))
    return pod


def is_controlled_by(pod: objects.Pod, kind: str) -> bool:
    return any(
        ref.controller and ref.kind == kind
        for ref in pod.metadata.owner_references
    )
