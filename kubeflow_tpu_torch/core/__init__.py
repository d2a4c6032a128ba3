"""The pod's side of the controller's contracts: the session-state
store the checkpoint sidecar writes."""
