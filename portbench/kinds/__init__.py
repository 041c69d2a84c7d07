"""The kinds of traffic, one module a kind (`portbench/kinds/<kind>.py`),
found by the name a traffic file gives: each holds `Cell`, `check` and
`readings`."""
