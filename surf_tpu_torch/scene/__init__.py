"""Scene description, camera and the scene compiler."""
