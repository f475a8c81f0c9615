"""Host-side image preparation of job inputs: geometry helpers and the
ControlNet condition-image preprocessors."""
