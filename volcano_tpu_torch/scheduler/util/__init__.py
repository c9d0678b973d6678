"""Scheduler helpers: priority queue, parallel predicate/score helpers,
test object builders and fake effectors."""
