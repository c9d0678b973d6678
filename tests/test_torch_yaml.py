"""The port's YAML reader (volcano_tpu_torch/utils/yaml_subset.py) against
PyYAML.

The machine with the card has no PyYAML, so the port reads the scheduler
conf, Job manifests and ``--cluster-state`` corpora with its own reader of
a block-style subset. For every file under example/ (invalid_jobs/
included), the vcctl demo Job, the confs the daemon reads (the reference's
default and batch-solve confs, the conf chip_smoke's daemon phase writes),
the Job manifests that phase submits and a few crafted streams, ``parse_yaml_all`` equals
``list(yaml.safe_load_all(...))`` and, for one-document streams,
``parse_yaml`` equals ``yaml.safe_load``. A non-empty flow collection, an
anchor, a tag and a block scalar are still refused. Tolerance: exact
equality.
"""

from __future__ import annotations

import glob
import os

import pytest
import yaml

from volcano_tpu_torch.cli.vcctl import DEMO_JOB_YAML
from volcano_tpu_torch.scheduler.scheduler import (
    DEFAULT_SCHEDULER_CONF, TPU_SCHEDULER_CONF)
from volcano_tpu_torch.utils.yaml_subset import parse_yaml, parse_yaml_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "example", "**", "*.yaml"),
                            recursive=True))


def _daemon_conf():
    import chip_smoke

    return chip_smoke.daemon_conf()


STREAMS = {
    "demo-job": DEMO_JOB_YAML,
    "default-conf": DEFAULT_SCHEDULER_CONF,
    "tpu-conf": TPU_SCHEDULER_CONF,
    "empty": "",
    "only-comments": "# nothing\n# here\n",
    "leading-marker": "---\na: 1\n",
    "empty-documents": "---\n---\na: []\n---\n",
    "content-then-marker": "a: 1\n---\nb: {}\n",
    "empty-flows": "a: []\nb: {}\nc:\n  - []\n  - {}\n  - d: [ ]\n",
    "null-document": "---\n# only a comment\n---\nx: y\n",
}


def _same(text):
    assert parse_yaml_all(text) == list(yaml.safe_load_all(text))
    if len(list(yaml.safe_load_all(text))) <= 1:
        assert parse_yaml(text) == yaml.safe_load(text)


def test_example_corpus_is_covered():
    names = {os.path.relpath(p, REPO) for p in EXAMPLES}
    assert {"example/job.yaml", "example/cluster.yaml",
            "example/invalid_jobs/minavailable-deny.yaml"} <= names


@pytest.mark.parametrize("path", EXAMPLES,
                         ids=[os.path.relpath(p, REPO) for p in EXAMPLES])
def test_example_files_read_as_pyyaml_reads_them(path):
    with open(path) as f:
        _same(f.read())


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_streams_read_as_pyyaml_reads_them(name):
    _same(STREAMS[name])


def test_daemon_phase_conf_reads_as_pyyaml_reads_it():
    _same(_daemon_conf())


def test_multi_document_stream_needs_parse_yaml_all():
    with pytest.raises(ValueError, match="one YAML document"):
        parse_yaml("a: 1\n---\nb: 2\n")


@pytest.mark.parametrize("text", [
    "a: [1, 2]", "a: {b: 1}", "a:\n  - [x]\n", "a: &x 1", "a: !tag 1",
    "a: |\n  text\n", "a: >\n  text\n", "a: *x",
])
def test_other_constructs_are_refused(text):
    with pytest.raises(ValueError):
        parse_yaml(text)


def test_daemon_phase_job_manifests_read_back_as_their_jobs():
    """chip_smoke's phase 17 submits cfg2's Jobs as manifests through
    ``cli.job.run_job``: each reads back as the Job it was written from."""
    import chip_smoke
    from volcano_tpu_torch.api import codec
    from volcano_tpu_torch.cli.job import job_from_yaml

    def wire(job):
        env = codec.envelope(job)
        env["object"]["metadata"].pop("uid", None)
        return env

    _, jobs = chip_smoke.cfg2_cluster(0.02)
    for job in jobs:
        text = chip_smoke.job_manifest(job)
        _same(text)
        assert wire(job_from_yaml(text)) == wire(job)
