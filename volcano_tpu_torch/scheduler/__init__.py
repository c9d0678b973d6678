"""Scheduler: cache, framework (session/plugins/statement), actions,
policy plugins, metrics, conf, and the periodic driver."""
