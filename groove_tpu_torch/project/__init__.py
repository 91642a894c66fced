"""Project-file front end: JSON5 parsing, settings schema, patch loading
(copies of groove_tpu/project)."""
