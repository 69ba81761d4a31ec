"""Host-side utilities (numpy only): synthetic scenes, trajectory metrics."""
