"""vcctl-analog CLI (volcano pkg/cli/{job,queue} + cmd/cli/vcctl.go)."""
