"""Scheduler cache: the cluster mirror + effector seam."""

from volcano_tpu_torch.scheduler.cache.interface import (
    Binder,
    Evictor,
    StatusUpdater,
    VolumeBinder,
)
from volcano_tpu_torch.scheduler.cache.cache import (
    SchedulerCache,
    DefaultBinder,
    DefaultEvictor,
    DefaultStatusUpdater,
    DefaultVolumeBinder,
)
