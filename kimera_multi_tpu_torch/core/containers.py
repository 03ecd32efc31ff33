"""Loop-closure status codes.

The verification status of every attempted loop closure, with the values
and names of the reference's output_lcd_status.csv (the JAX package's
core/containers.py). The pose-graph containers follow with the back-end.
"""

LCD_LOOP_DETECTED = 0
LCD_FAILED_TEMPORAL_CONSTRAINT = 1
LCD_FAILED_GEOM_VERIFICATION = 2
LCD_FAILED_POSE_RECOVERY = 3
LCD_NO_MATCHES = 4
LCD_STATUS_NAMES = {
    LCD_LOOP_DETECTED: "LOOP_DETECTED",
    LCD_FAILED_TEMPORAL_CONSTRAINT: "FAILED_TEMPORAL_CONSTRAINT",
    LCD_FAILED_GEOM_VERIFICATION: "FAILED_GEOM_VERIFICATION",
    LCD_FAILED_POSE_RECOVERY: "FAILED_POSE_RECOVERY",
    LCD_NO_MATCHES: "NO_MATCHES",
}
